"""The checkpoint -> serve path held against the reference on the CPU.

The reference's tiny pFedPara federation (``repro.launch.serve.
tiny_fl_checkpoint``: reduced qwen3-8b, 2 layers, 2 clients, 2 rounds,
fp32) is trained and checkpointed by the reference; then:

* the port's federation (``repro_torch.launch.serve.build_federation``)
  from the same reference init matches it record for record: arrived
  masks and sampled clients bitwise, losses, global params and each
  client's personal half within ``DEFAULT_ATOL = 1e-4``
  (``tests/parity.py:54``);
* ``repro_torch.serve.ServeEngine.from_checkpoint`` on the reference's
  checkpoint serves each user as the reference's engine does, at the
  reference's per-mode bounds (``tests/test_serve.py:233-237``): fused
  1e-4, fp16 cache 5e-3, int8 cache 8e-2 relative;
* the reference reads the port's checkpoint of its own run bit for bit
  and serves it (fused) within 1e-4 of the port's engine;
* the serving CLI (``--ckpt``, the self-trained default and
  ``--smoke``) runs on ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import DEFAULT_ATOL
from repro.checkpoint import CheckpointManager as JaxManager
from repro.launch.serve import tiny_fl_checkpoint as jax_tiny_fl_checkpoint
from repro.nn.transformer import build_model as jax_build_model
from repro.serve import ServeEngine as JaxEngine

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, unflatten_paths
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.launch import serve
from repro_torch.nn.transformer import ModelOptions
from repro_torch.serve import ServeEngine

ROUNDS, CLIENTS = 2, 2
TOL = {("fused", "int8"): 1e-4, ("precompose", "fp16"): 5e-3,
       ("precompose", "int8"): 8e-2}
SERVE_OPTS = ModelOptions(attn_chunk=8, dtype=torch.float32)
B, S, STEPS = 2, 8, 4
UIDS = [0, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def feds(tmp_path_factory):
    """The reference's tiny federation (checkpointed) and the port's run
    of it from the same init (checkpointed too)."""
    d_ref = str(tmp_path_factory.mktemp("ref_ckpt"))
    _, jcfg, jopts = jax_tiny_fl_checkpoint(d_ref, rounds=ROUNDS,
                                            clients=CLIENTS, seed=0)
    init = jax_build_model(jcfg, jopts).init_params(jax.random.PRNGKey(0))
    pcfg = serve.tiny_config("qwen3-8b", "pfedpara")
    srv = serve.build_federation(
        pcfg, serve.TINY_OPTS, rounds=ROUNDS, clients=CLIENTS, seed=0,
        device="cpu",
        params=interop.from_jax_params(jax.tree.map(np.asarray, init)))
    srv.run()
    d_port = str(tmp_path_factory.mktemp("port_ckpt"))
    srv.save_checkpoint(CheckpointManager(d_port))
    return {"ref": d_ref, "jcfg": jcfg, "jopts": jopts, "port": d_port,
            "pcfg": pcfg, "srv": srv}


def _maxdiff(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    return max(float((x.float() - y.float()).abs().max())
               for (_, x), (_, y) in zip(fa, fb))


def test_port_federation_matches_the_reference_run(feds):
    by_path, extra, step = CheckpointManager(feds["ref"]).restore_items()
    srv = feds["srv"]
    assert step == srv.round_idx == ROUNDS
    want = extra["history"]
    assert len(want) == len(srv.history) == ROUNDS
    for r, g in zip(want, srv.history):
        for k in ("arrived_mask", "sampled", "participants", "down_bytes",
                  "up_bytes", "round"):
            assert g[k] == r[k], k
        assert abs(g["mean_loss"] - r["mean_loss"]) < DEFAULT_ATOL
    assert extra["comm"] == [srv.comm_log.down_bytes, srv.comm_log.up_bytes,
                             ROUNDS]
    gp = unflatten_paths(by_path, prefix="global_params")
    assert _maxdiff(gp, srv.global_params) < DEFAULT_ATOL
    for cid in range(CLIENTS):
        local = unflatten_paths(by_path, prefix=f"local_trees/{cid}")
        assert _maxdiff(local, srv.local_trees[cid]) < DEFAULT_ATOL
    # training moved the weights
    init_embed = jax_build_model(feds["jcfg"], feds["jopts"]).init_params(
        jax.random.PRNGKey(0))["embed"]["w"]
    assert float((srv.global_params["embed"]["w"]
                  - torch.from_numpy(np.array(init_embed))).abs().max()) \
        > 1e-4


def _prompts(vocab):
    return np.random.default_rng(9).integers(0, vocab, size=(B, S))


def _forced(eng, prompts, toks, to_np):
    """Prefill, then decode feeding ``toks``; logits of every step."""
    cache = eng.init_cache(B, S + STEPS)
    cache, logits = eng.prefill(prompts, cache, user_ids=UIDS)
    out = [to_np(logits)]
    for i in range(STEPS):
        logits, cache = eng.decode_step(cache, toks[:, i:i + 1], S + i,
                                        user_ids=UIDS)
        out.append(to_np(logits))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


@pytest.mark.parametrize("mode,cache_dtype", list(TOL))
def test_port_serves_the_reference_checkpoint(feds, mode, cache_dtype):
    jeng = JaxEngine.from_checkpoint(feds["ref"], feds["jcfg"], mode=mode,
                                     cache_dtype=cache_dtype, batch=B,
                                     opts=feds["jopts"])
    prompts = _prompts(feds["jcfg"].vocab_size)
    toks = np.random.default_rng(3).integers(
        0, feds["jcfg"].vocab_size, size=(B, STEPS))
    want = _forced(jeng, jnp.asarray(prompts), jnp.asarray(toks), np.asarray)
    peng = ServeEngine.from_checkpoint(feds["ref"], feds["pcfg"], mode=mode,
                                       cache_dtype=cache_dtype, batch=B,
                                       opts=SERVE_OPTS, device="cpu")
    assert peng.arena is not None and peng.arena.uids == UIDS
    got = _forced(peng, torch.from_numpy(prompts), torch.from_numpy(toks),
                  lambda t: t.numpy())
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < TOL[(mode, cache_dtype)], errs


def test_reference_reads_and_serves_the_port_checkpoint(feds):
    want, _, step = JaxManager(feds["port"]).restore_items()
    got, _, _ = CheckpointManager(feds["port"]).restore_items()
    assert step == ROUNDS and list(want) == list(got)
    for p in got:
        assert np.asarray(want[p]).tobytes() == got[p].numpy().tobytes(), p
    jeng = JaxEngine.from_checkpoint(feds["port"], feds["jcfg"],
                                     mode="fused", batch=B,
                                     opts=feds["jopts"])
    peng = ServeEngine.from_checkpoint(feds["port"], feds["pcfg"],
                                       mode="fused", batch=B,
                                       opts=SERVE_OPTS, device="cpu")
    prompts = _prompts(feds["jcfg"].vocab_size)
    toks = np.zeros((B, STEPS), np.int64)
    w = _forced(jeng, jnp.asarray(prompts), jnp.asarray(toks), np.asarray)
    g = _forced(peng, torch.from_numpy(prompts), torch.from_numpy(toks),
                lambda t: t.numpy())
    assert max(_rel(a, b) for a, b in zip(g, w)) < 1e-4


def test_load_fl_checkpoint_finds_the_users(feds):
    from repro_torch.serve import load_fl_checkpoint

    gp, local, extra, step = load_fl_checkpoint(feds["port"], device="cpu")
    assert step == ROUNDS and sorted(local) == UIDS
    assert extra["round_idx"] == ROUNDS
    srv = feds["srv"]
    assert _maxdiff(gp, srv.global_params) == 0.0
    for u in UIDS:
        assert _maxdiff(local[u], srv.local_trees[u]) == 0.0
        assert sorted(local[u]["layers"]["attn"]["wq"]) == ["x2", "y2"]


def test_serve_cli_serves_a_checkpoint(feds, capsys):
    rep = serve.main(["--ckpt", feds["ref"], "--users", "2", "--device",
                      "cpu", "--mode", "precompose", "--prompt-len", "4",
                      "--gen-len", "2"])
    assert rep["tokens"].shape == (2, 2) and rep["device"] == "cpu"
    out = capsys.readouterr().out
    assert '"kind": "pfedpara"' in out and "trained" not in out


def test_serve_cli_trains_its_own_federation_and_runs_the_smoke(capsys):
    rep = serve.main(["--device", "cpu", "--rounds", "1", "--mode", "fused",
                      "--prompt-len", "4", "--gen-len", "2"])
    assert rep["tokens"].shape == (2, 2)
    assert "trained + checkpointed tiny federation (1 rounds)" in \
        capsys.readouterr().out
    assert serve.main(["--smoke", "--device", "cpu"])["smoke_rel_err"] < 2e-2


def test_tiny_config_is_the_reference_reduction(feds):
    jcfg, pcfg = feds["jcfg"], feds["pcfg"]
    for f in dataclasses.fields(pcfg):
        if f.name != "param":
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(pcfg.param):
        if hasattr(jcfg.param, f.name):
            assert getattr(pcfg.param, f.name) == \
                getattr(jcfg.param, f.name), f.name
