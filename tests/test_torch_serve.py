"""The PyTorch port's serving slice held against the JAX reference.

The same reduced qwen3-8b params (initialized by the reference, carried
across by ``repro_torch.interop``), the same prompts (2 x 8) and 8 greedy
decode steps go through ``repro.serve.ServeEngine`` (Pallas kernels in
interpret mode, fp32) and ``repro_torch.serve.ServeEngine`` on the CPU
(the kernels' plain versions). Logits are held to the reference's own
per-mode bounds (``tests/test_serve.py``: fused 1e-4, fp16 5e-3, int8
8e-2 relative) and the generated tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.nn.transformer import ModelOptions as JaxOptions
from repro.nn.transformer import build_model as jax_build_model
from repro.serve import ServeEngine as JaxEngine

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.nn.transformer import ModelOptions, build_model
from repro_torch.serve import ServeEngine

TOL = {"fused": 1e-4, "precompose/fp16": 5e-3, "precompose/int8": 8e-2}
B, S, STEPS = 2, 8, 8


def _cfgs(kind):
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get("qwen3-8b").reduced()
        out.append(dataclasses.replace(cfg, n_layers=2, param=dataclasses.replace(
            cfg.param, kind=kind, min_dim_for_factorization=8, gamma=0.5)))
    return out


_JOPTS = JaxOptions(attn_chunk=8, ssm_chunk=8, logit_chunk=16,
                    dtype=jnp.float32)
_POPTS = ModelOptions(attn_chunk=8, dtype=torch.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _users(params, n):
    """Per-user personal halves: the global x2/y2 plus seeded noise."""
    from repro.fl import comm

    local = jax.tree.map(np.asarray, comm.split_pfedpara(params)[1])
    rng = np.random.default_rng(5)
    return {u: jax.tree.map(
        lambda a: (a + 0.3 * a.std() * rng.standard_normal(a.shape)
                   ).astype(np.float32), local) for u in range(n)}


def _run(eng, prompts, uids, to_np):
    cache = eng.init_cache(B, S + STEPS)
    cache, logits = eng.prefill(prompts, cache, user_ids=uids)
    steps, toks = [to_np(logits)], []
    for i in range(STEPS):
        tok = np.argmax(to_np(logits), -1)[:, None]
        toks.append(tok[:, 0])
        logits, cache = eng.decode_step(cache, tok, S + i, user_ids=uids)
        steps.append(to_np(logits))
    return steps, np.stack(toks, 1)


@pytest.mark.parametrize("kind,mode,cache_dtype,users", [
    ("fedpara", "precompose", "int8", 0),
    ("fedpara", "precompose", "fp16", 0),
    ("fedpara", "fused", "int8", 0),
    ("pfedpara", "precompose", "int8", 2),
    ("pfedpara", "fused", "int8", 2),
])
def test_port_engine_matches_reference_engine(kind, mode, cache_dtype, users):
    jcfg, pcfg = _cfgs(kind)
    jparams = jax_build_model(jcfg, _JOPTS).init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    local = _users(jparams, users) if users else None
    uids = list(range(users)) if users else None
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)

    jeng = JaxEngine(jcfg, jparams, local, mode=mode, cache_dtype=cache_dtype,
                     batch=B, use_pallas=True, opts=_JOPTS)
    want, want_toks = _run(jeng, jnp.asarray(prompts), uids,
                           lambda t: np.asarray(t))

    peng = ServeEngine(
        pcfg, interop.from_jax_params(np_params),
        {u: interop.from_jax_params(t) for u, t in local.items()}
        if local else None,
        mode=mode, cache_dtype=cache_dtype, batch=B, opts=_POPTS,
        device="cpu")
    got, got_toks = _run(peng, torch.from_numpy(prompts).long(), uids,
                         lambda t: t.numpy())

    tol = TOL["fused" if mode == "fused" else f"{mode}/{cache_dtype}"]
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, pcfg.vocab_size)
        assert np.isfinite(g).all()
        assert _rel(g, w) < tol, (kind, mode, cache_dtype, step, _rel(g, w))
    np.testing.assert_array_equal(got_toks, want_toks)


def test_port_plan_matches_reference_plan_when_forced():
    jcfg, pcfg = _cfgs("fedpara")
    jparams = jax_build_model(jcfg, _JOPTS).init_params(jax.random.PRNGKey(0))
    pparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams))
    for mode in ("precompose", "fused"):
        jeng = JaxEngine(jcfg, jparams, mode=mode, batch=B, use_pallas=False,
                         opts=_JOPTS)
        peng = ServeEngine(pcfg, pparams, mode=mode, batch=B, opts=_POPTS,
                           device="cpu")
        jrows, prows = jeng.decision_table(), peng.decision_table()
        assert [(r["path"], r["m"], r["n"], r["r"], r["mode"])
                for r in jrows] == [(r["path"], r["m"], r["n"], r["r"],
                                     r["mode"]) for r in prows]
        assert peng.state_bytes() == jeng.state_bytes()


def test_generate_returns_greedy_tokens():
    _, pcfg = _cfgs("fedpara")
    params = build_model(pcfg).init_params(torch.Generator().manual_seed(0))
    eng = ServeEngine(pcfg, params, mode="precompose", batch=B, opts=_POPTS,
                      device="cpu")
    prompts = torch.randint(0, pcfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1))
    toks = eng.generate(prompts, 4)
    _, want = _run(eng, prompts, None, lambda t: t.numpy())
    assert toks.shape == (B, 4)
    np.testing.assert_array_equal(toks.numpy(), want[:, :4])


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    rep = serve.main(["--reduced", "--device", "cpu", "--layers", "2",
                      "--prompt-len", "4", "--gen-len", "2", "--users", "2",
                      "--mode", "precompose"])
    assert rep["tokens"].shape == (2, 2)
    assert rep["device"] == "cpu" and rep["clock"] == "host"
    assert '"kind": "pfedpara"' in capsys.readouterr().out


def test_serve_cli_round_trips_npz_params(tmp_path, capsys):
    from repro_torch.launch import serve

    _, pcfg = _cfgs("fedpara")
    params = build_model(pcfg).init_params(torch.Generator().manual_seed(3))
    path = str(tmp_path / "p.npz")
    interop.save_npz(params, path)
    args = ["--reduced", "--device", "cpu", "--layers", "2", "--prompt-len",
            "4", "--gen-len", "2", "--mode", "fused", "--seed", "3"]
    a = serve.main(args + ["--params", path])
    # the same tree served in memory, on the prompts the CLI draws
    prompts = np.random.default_rng(3 + 1).integers(
        0, pcfg.vocab_size, size=(2, 4))
    eng = ServeEngine(pcfg, params, mode="fused", batch=2, device="cpu")
    b = serve.serve_timed(eng, torch.from_numpy(prompts), 2)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
