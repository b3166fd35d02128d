"""The port's copied and ported core pieces held against the reference:
rank policy, inits, the interop carry, the pFedPara split, the cost
model's byte/FLOP algebra, the serve cache rewrite, the import boundary
and the device rule of the entry points."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import parameterization as jpar
from repro.core import rank_policy as jrank
from repro.fl import comm as jcomm
from repro.nn.transformer import DecoderLM as JaxDecoderLM
from repro.serve import build_serve_params as jbuild
from repro.serve import cost_model as jcost

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import parameterization as par
from repro_torch.core import rank_policy
from repro_torch.fl import comm
from repro_torch.nn.transformer import DecoderLM
from repro_torch.serve import build_serve_params, cost_model

REPO = Path(__file__).resolve().parents[1]

# qwen3-8b's projections at full width and their γ = 0.1 ranks
QWEN3_8B = {"wq": (4096, 4096, 160), "wo": (4096, 4096, 160),
            "wk": (4096, 1024, 70), "wv": (4096, 1024, 70),
            "w_gate": (4096, 12288, 211), "w_up": (4096, 12288, 211),
            "w_down": (12288, 4096, 211)}


@pytest.mark.parametrize("name", sorted(QWEN3_8B))
def test_qwen3_8b_ranks_equal_reference(name):
    m, n, r = QWEN3_8B[name]
    assert rank_policy.matrix_rank_for_gamma(m, n, 0.1) == r
    assert jrank.matrix_rank_for_gamma(m, n, 0.1) == r


def test_rank_policy_equals_reference_on_a_sweep():
    rng = np.random.default_rng(0)
    for _ in range(300):
        m, n = (int(v) for v in rng.integers(1, 5000, size=2))
        g = float(rng.uniform())
        assert rank_policy.matrix_rmin(m, n) == jrank.matrix_rmin(m, n)
        assert rank_policy.matrix_rmax(m, n) == jrank.matrix_rmax(m, n)
        assert (rank_policy.matrix_rank_for_gamma(m, n, g)
                == jrank.matrix_rank_for_gamma(m, n, g))


@pytest.mark.parametrize("kind", ["fedpara", "pfedpara"])
def test_qwen3_8b_layer_shapes_and_counts_equal_reference(kind):
    jcfg = jax_get_arch("qwen3-8b")
    jcfg = dataclasses.replace(jcfg, param=dataclasses.replace(jcfg.param,
                                                               kind=kind))
    pcfg = get_arch("qwen3-8b")
    pcfg = dataclasses.replace(pcfg, param=dataclasses.replace(pcfg.param,
                                                               kind=kind))
    want = jax.eval_shape(JaxDecoderLM(jcfg).init_layer, jax.random.PRNGKey(0))
    got = DecoderLM(pcfg).init_layer(torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    pflat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_flatten_with_path(got)[0]}
    assert pflat == jflat
    for name, (m, n, r) in QWEN3_8B.items():
        sub = got["mlp" if name.startswith("w_") else "attn"][name]
        assert sum(v.numel() for v in sub.values()) == 2 * r * (m + n)


@pytest.mark.parametrize("kind", ["fedpara", "pfedpara"])
def test_init_statistics_match_the_parameterization(kind):
    gen = torch.Generator().manual_seed(0)
    node = par.init_linear(gen, 512, 256, kind=kind, gamma=0.3)
    r = rank_policy.matrix_rank_for_gamma(512, 256, 0.3)
    assert node["x1"].shape == (512, r) and node["y2"].shape == (256, r)
    std = (par.fedpara_factor_std(512, r) if kind == "fedpara"
           else par.lowrank_factor_std(512, r))
    assert abs(node["x1"].std().item() / std - 1) < 0.05
    jstd = (jpar.fedpara_factor_std(512, r) if kind == "fedpara"
            else jpar.lowrank_factor_std(512, r))
    assert std == pytest.approx(jstd, rel=1e-12)


@pytest.mark.parametrize("kind", ["fedpara", "fedpara_tanh", "pfedpara"])
def test_materialize_equals_reference(kind):
    rng = np.random.default_rng(3)
    node = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for k, s in (("x1", (40, 6)), ("y1", (30, 6)), ("x2", (40, 6)),
                         ("y2", (30, 6)))}
    want = np.asarray(jpar.materialize(jax.tree.map(jnp.asarray, node), kind))
    got = par.materialize(interop.from_jax_params(node), kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def _reduced_ref_params(kind="fedpara"):
    cfg = jax_get_arch("qwen3-8b").reduced()
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, kind=kind, min_dim_for_factorization=8, gamma=0.5))
    return cfg, JaxDecoderLM(cfg).init_params(jax.random.PRNGKey(0))


def test_interop_round_trips_reference_params_bitwise(tmp_path):
    _, params = _reduced_ref_params()
    np_params = jax.tree.map(np.asarray, params)
    back = interop.to_numpy(interop.from_jax_params(np_params))
    path = str(tmp_path / "p.npz")
    interop.save_npz(np_params, path)
    loaded = interop.to_numpy(interop.load_npz(path))
    ref_flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    for tree in (back, loaded):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [jax.tree_util.keystr(p) for p, _ in flat] == \
            [jax.tree_util.keystr(p) for p, _ in ref_flat]
        for (_, a), (_, b) in zip(flat, ref_flat):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    # the vmap-stacked layer axis carries across
    assert back["layers"]["attn"]["wq"]["x1"].shape[0] == 4


def test_split_pfedpara_equals_reference():
    _, params = _reduced_ref_params("pfedpara")
    np_params = jax.tree.map(np.asarray, params)
    jg, jl = jcomm.split_pfedpara(np_params)
    pg, pl = comm.split_pfedpara(interop.from_jax_params(np_params))
    for want, got in ((jg, pg), (jl, pl)):
        wf = jax.tree_util.tree_flatten_with_path(want)[0]
        gf = jax.tree_util.tree_flatten_with_path(interop.to_numpy(got))[0]
        assert [jax.tree_util.keystr(p) for p, _ in wf] == \
            [jax.tree_util.keystr(p) for p, _ in gf]


@pytest.mark.parametrize("users,kind", [(0, "fedpara"), (0, "fedpara_tanh"),
                                        (4, "pfedpara")])
@pytest.mark.parametrize("batch", [1, 4, 512])
def test_cost_model_bytes_and_flops_equal_reference(users, kind, batch):
    for m, n, r in QWEN3_8B.values():
        for wd in ("int8", "fp16"):
            want = jcost.mode_costs(m, n, r, batch, kind=kind,
                                    weight_dtype=wd, users=users)
            got = cost_model.mode_costs(m, n, r, batch, kind=kind,
                                        weight_dtype=wd, users=users)
            assert got["precompose"]["bytes"] == want["precompose"]["bytes"]
            assert got["precompose"]["flops"] == want["precompose"]["flops"]
            if kind == "fedpara_tanh" or users:
                assert {k: got["fused"][k] for k in want["fused"]} \
                    == want["fused"]


def test_cost_model_uses_h100_roofline():
    # 1 GB at 3.35 TB/s, 989 GFLOP at 989 TFLOP/s
    assert cost_model.predict_us(1e9, 0.0) == pytest.approx(1e9 / 3.35e6)
    assert cost_model.predict_us(0.0, 989e9) == pytest.approx(1e3)
    # the tile kernel's 4mnr compose runs on fp32 CUDA cores, so the Gram
    # identity (2Br²(m+n) fp32 FLOPs) wins while B < 2mn / (r(m+n)),
    # 25.6 rows at 4096 x 4096, r = 160: decode takes Gram, prefill K1
    for batch, impl in ((1, "gram"), (4, "gram"), (64, "tile"),
                        (512, "tile")):
        d = cost_model.decide("p", 4096, 4096, 160, batch=batch, mode="fused")
        assert d.mode == "fused" and d.impl == impl


def test_cost_model_prices_compose_at_the_fp32_rate():
    # 67 GFLOP of fp32 work at 67 TFLOP/s, beside 989 GFLOP of bf16 work
    assert cost_model.predict_us(0.0, 67e9, 67e9) == pytest.approx(1e3)
    assert cost_model.predict_us(0.0, 989e9 + 67e9, 67e9) == \
        pytest.approx(2e3)
    m, n, r = QWEN3_8B["w_gate"]
    for batch in (4, 512):
        c = cost_model.mode_costs(m, n, r, batch, kind="fedpara_tanh")
        tile = c["fused"]
        assert tile["impl"] == "tile"
        assert tile["fp32_flops"] == -(-batch // 64) * 4.0 * m * n * r
        want = (tile["fp32_flops"] / 67e6
                + (tile["flops"] - tile["fp32_flops"]) / 989e6)
        assert cost_model.predict_us(**cost_model._bf(tile)) == \
            pytest.approx(want)
        assert c["precompose"]["fp32_flops"] == 0.0
    users = cost_model.mode_costs(m, n, r, 4, kind="pfedpara", users=4)
    assert users["precompose"]["fp32_flops"] == 4 * 2.0 * m * n * (r + 1)
    assert users["fused"]["fp32_flops"] == users["fused"]["flops"]


@pytest.mark.parametrize("cache_dtype", ["int8", "fp16"])
def test_serve_cache_per_layer_equals_reference(cache_dtype):
    cfg, params = _reduced_ref_params()
    plan = jcost.plan_params(params, "fedpara", batch=2, mode="precompose",
                             weight_dtype=cache_dtype)
    want = jax.tree.map(np.asarray, jbuild(params, "fedpara", plan,
                                           cache_dtype))
    pparams = interop.from_jax_params(jax.tree.map(np.asarray, params))
    pplan = cost_model.plan_params(pparams, "fedpara", batch=2,
                                   mode="precompose",
                                   weight_dtype=cache_dtype)
    got = interop.to_numpy(build_serve_params(pparams, "fedpara", pplan,
                                              cache_dtype))
    wf = jax.tree_util.tree_flatten_with_path(want)[0]
    gf = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in wf] == \
        [jax.tree_util.keystr(p) for p, _ in gf]
    for (path, w), (_, g) in zip(wf, gf):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype == np.int8:   # codes may differ by one at .5 ties
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
            assert (g != w).mean() < 1e-3
        else:
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32),
                                       rtol=1e-3, atol=1e-6)


def test_port_imports_neither_jax_nor_reference():
    """Import every module of the port in a fresh interpreter and check
    that neither jax nor the reference package was loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "new = {'repro_torch.kernels.agg', 'repro_torch.fl.batch_engine', "
        "'repro_torch.fl.stream_engine', 'repro_torch.checkpoint', "
        "'repro_torch.checkpoint.manager', 'repro_torch.checkpoint.manifest', "
        "'repro_torch.kernels.fedpara_compose'}\n"
        "bad += sorted(k for k in sys.modules if k == 'msgpack' or "
        "k.startswith('msgpack.'))\n"
        "print(len(mods), bad, sorted(new - set(mods)))\n"
        "sys.exit(1 if bad or len(mods) < 20 or not new <= set(mods) "
        "else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    cfg = get_arch("qwen3-8b").reduced()
    params = DecoderLM(cfg).init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, mode="precompose")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--layers", "2"])
    # the checkpoint -> serve slice's entry points
    from repro_torch.serve import load_fl_checkpoint

    for argv in (["--ckpt", "no-such-dir"], ["--smoke"], []):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine.from_checkpoint("no-such-dir", cfg, mode="precompose")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_fl_checkpoint("no-such-dir")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.tiny_fl_checkpoint("no-such-dir", rounds=1, clients=2)
    # the training slice's entry points
    from repro_torch.fl.client import ClientConfig
    from repro_torch.fl.server import FLServer, ServerConfig
    from repro_torch.fl.strategies import make_strategy
    from repro_torch.launch import train

    for engine in ("sequential", "batched", "streaming"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FLServer(lambda p, b: p["w"].sum(), {"w": torch.zeros(3)}, {},
                     [], make_strategy("fedavg"), ClientConfig(),
                     ServerConfig(engine=engine))
    for engine in ([], ["--engine", "batched"],
                   ["--engine", "streaming", "--client-chunk", "3"],
                   ["--engine", "sequential"],
                   ["--ckpt-dir", "no-such-dir", "--resume"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--mode", "fl", "--model", "mlp", "--rounds", "1",
                        *engine])
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cli_defaults_to_the_reference_mode(monkeypatch):
    """With no arguments the port's CLI picks the reference's default
    mode (``pods``) and refuses it by its ROADMAP item."""
    import argparse

    from repro.launch import train as jtrain
    from repro_torch.launch import train

    port_default = train.parser().parse_args([]).mode

    class Parsed(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise Parsed(orig(self, [], namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed) as got:
        jtrain.main()
    monkeypatch.undo()
    assert port_default == got.value.args[0].mode == "pods"
    with pytest.raises(SystemExit, match="A8"):
        train.main([])


def test_lowrank_kind_is_refused_by_its_roadmap_item():
    """The low-rank kind is ported (ROADMAP A2's core math): the port's
    init has the reference's layout at twice the FedPara rank, and its
    materialize equals the reference's on the reference's factors; a
    truly unknown kind keeps its ``ValueError``."""
    jnode = jpar.init_linear(jax.random.PRNGKey(0), 16, 12, kind="lowrank",
                             gamma=0.3)
    gen = torch.Generator().manual_seed(0)
    mine = par.init_linear(gen, 16, 12, kind="lowrank", gamma=0.3)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jnode.items()}
    node = interop.from_jax_params(jax.tree.map(np.asarray, jnode))
    np.testing.assert_allclose(par.materialize(node, "lowrank").numpy(),
                               np.asarray(jpar.materialize(jnode, "lowrank")),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown parameterization kind"):
        par.init_linear(gen, 16, 12, kind="bogus")
    with pytest.raises(ValueError, match="unknown parameterization kind"):
        par.materialize(node, "bogus")
