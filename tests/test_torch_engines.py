"""The port's batched and streaming FL engines held against the reference
on the CPU, where the kernels take their plain versions: the numpy
client stack and the chunk layout bit for bit; the dequant-accumulate
(K7's plain version and the tree walk) against the reference's Pallas
kernel in interpret mode; the client-stacked ``FedParaMatmul`` (K2 and
the client forms of K3/K4) against ``jax.grad`` through the reference's
custom VJP on 3-D inputs and the closed-form oracle; one
``batched_local_update`` per strategy; ``FLServer`` with
``engine="batched"`` and ``engine="streaming"`` over 3 rounds; and the
training CLI record for record. Tolerances are the reference's: rtol
1e-4 for K7 (``tests/test_agg_kernel.py``), 5e-4 for kernel gradients
(``tests/test_kernel_grads.py:61``), ``DEFAULT_ATOL = 1e-4`` for
engines (``tests/parity.py:54``); masks, wire bytes and layouts exact.
Both sides start from the parameters the reference initialized.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity import DEFAULT_ATOL, N_CLIENTS, get_task, make_model
from repro.configs.base import ParamCfg as JParamCfg
from repro.data import loader as jloader
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.fl import batch_engine as jbatch
from repro.fl import client as jclient
from repro.fl import comm as jcomm
from repro.fl import make_strategy as jmake_strategy
from repro.fl import stream_engine as jstream
from repro.kernels import agg as jagg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import recurrent as jrec

from repro_torch import interop
from repro_torch.configs.base import ParamCfg
from repro_torch.data import loader
from repro_torch.fl import batch_engine, client, stream_engine
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.kernels import agg, ops, ref
from repro_torch.launch import train
from repro_torch.nn import recurrent as rec

REPO = Path(__file__).resolve().parents[1]
STRATEGIES = ["fedavg", "fedprox", "scaffold", "feddyn", "fedadam"]
KINDS = ["fedpara", "fedpara_tanh", "pfedpara"]
AGG_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
NAMES = ("dx", "dx1", "dy1", "dx2", "dy2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs thousands of tiny tensor ops; with one
    intra-op thread they do not contend with the JAX reference and the
    other test workers for the host's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return interop.from_jax_params(_np(tree))


def _maxdiff(a, b):
    """Largest |a - b| over two trees (reference arrays / port tensors)."""
    a, b = _np(a), _np(interop.to_numpy(b))
    leaves = jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.abs(np.asarray(x, np.float64)
                                  - np.asarray(y, np.float64)).max()), a, b))
    return max(leaves) if leaves else 0.0


# ------------------------------------------- copied numpy layout helpers

@pytest.mark.parametrize("pad_steps,pad_clients", [(None, 0), (9, 3)])
def test_stack_client_epochs_equals_reference_bitwise(pad_steps, pad_clients):
    data = {"x": np.arange(400, dtype=np.float32).reshape(100, 4),
            "y": np.arange(100, dtype=np.int32)}
    parts = [np.arange(0, 40), np.arange(40, 45), np.arange(0),
             np.arange(45, 100)]
    cids, seeds = [3, 1, 2, 0], [11, 2 ** 40 + 5, 7, 0]
    want = jloader.stack_client_epochs(data, parts, cids, 8, 1, seeds,
                                       pad_steps=pad_steps,
                                       pad_clients=pad_clients)
    got = loader.stack_client_epochs(data, parts, cids, 8, 1, seeds,
                                     pad_steps=pad_steps,
                                     pad_clients=pad_clients)
    assert got[1].dtype == want[1].dtype
    assert got[1].tobytes() == want[1].tobytes()
    for k in data:
        assert got[0][k].shape == want[0][k].shape
        assert got[0][k].tobytes() == want[0][k].tobytes()
    with pytest.raises(ValueError, match="pad_steps"):
        loader.stack_client_epochs(data, parts, cids, 8, 1, seeds,
                                   pad_steps=1)


@pytest.mark.parametrize("n,chunk", [(4, 1), (4, 3), (4, 8), (7, 3),
                                     (1, 16)])
def test_chunk_layout_and_chunks_equal_reference(n, chunk):
    assert stream_engine.chunk_layout(n, chunk) == \
        jstream.chunk_layout(n, chunk)
    c, k, pad = stream_engine.chunk_layout(n, chunk)
    tree = {"a": np.arange((n + pad) * 6, dtype=np.float32).reshape(
        n + pad, 2, 3), "b": [np.arange(n + pad, dtype=np.int32)]}
    want = _np(jstream.to_chunks(tree, k, c))
    got = stream_engine.to_chunks(tree, k, c)
    assert jax.tree.map(lambda g, w: g.tobytes() == w.tobytes()
                        and g.shape == w.shape, got, want) == \
        {"a": True, "b": [True]}
    back = stream_engine.from_chunks(
        interop.from_jax_params({"a": got["a"]}))["a"]
    assert back.numpy().tobytes() == np.asarray(
        jstream.from_chunks(want)["a"]).tobytes()


# --------------------------------------------- K7: dequant-accumulate

def _rand_q(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("C,L", [(1, 7), (5, 37), (16, 512), (33, 600),
                                 (8, 4097), (64, 130)])
def test_dequant_acc_matches_reference_kernel(C, L):
    rng = np.random.default_rng(C * 1000 + L)
    q = _rand_q(rng, (C, L))
    coeff = rng.standard_normal(C).astype(np.float32)
    acc = rng.standard_normal(L).astype(np.float32)
    want = np.asarray(jagg.dequant_acc(jnp.asarray(acc), jnp.asarray(q),
                                       jnp.asarray(coeff), interpret=True))
    tacc = torch.from_numpy(acc.copy())
    out = ops.dequant_acc(tacc, torch.from_numpy(q), torch.from_numpy(coeff))
    assert out is tacc            # updated in place, as the kernel does
    np.testing.assert_allclose(out.numpy(), want, **AGG_TOL)
    np.testing.assert_allclose(
        ref.dequant_acc_ref(torch.from_numpy(acc), torch.from_numpy(q),
                            torch.from_numpy(coeff)).numpy(), want, **AGG_TOL)


def test_dequant_acc_masked_clients_contribute_zero():
    rng = np.random.default_rng(0)
    q = _rand_q(rng, (6, 200))
    coeff = np.array([1.0, 0.0, 2.0, 0.0, 0.0, 0.5], np.float32)
    keep = np.array([0, 2, 5])
    want = np.asarray(jref.dequant_acc_ref(
        jnp.zeros((200,)), jnp.asarray(q[keep]), jnp.asarray(coeff[keep])))
    got = ops.dequant_acc(torch.zeros(200), torch.from_numpy(q),
                          torch.from_numpy(coeff))
    np.testing.assert_allclose(got.numpy(), want, **AGG_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_dequant_acc_fp_wire_matches_reference_kernel(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 333)).astype(dtype)
    coeff = np.abs(rng.standard_normal(9)).astype(np.float32)
    acc = np.ones((333,), np.float32)
    want = np.asarray(jagg.dequant_acc(jnp.asarray(acc), jnp.asarray(x),
                                       jnp.asarray(coeff), interpret=True))
    got = ops.dequant_acc(torch.from_numpy(acc), torch.from_numpy(x),
                          torch.from_numpy(coeff))
    np.testing.assert_allclose(got.numpy(), want, **AGG_TOL)


def _int8_wire(payload, seed):
    """The reference's stacked int8 codec wire ({"q", "scale"} nodes)."""
    C = jax.tree.leaves(payload)[0].shape[0]
    return jax.vmap(lambda t, k: jcomm.quantize_int8(t, k))(
        payload, jax.random.split(jax.random.PRNGKey(seed), C))


def _check_tree(wire, w, acc0=None):
    """The port's tree walk against the reference kernel's, in interpret
    mode, on the same wire tree and weights."""
    jacc = jagg.acc_zeros_like(wire) if acc0 is None else acc0
    want = jagg.tree_dequant_acc(jacc, wire, jnp.asarray(w), interpret=True)
    tacc = _t(jacc)
    got = agg.tree_dequant_acc(tacc, _t(wire), torch.from_numpy(w))
    assert got is tacc
    oracle = ref.tree_dequant_acc_ref(_t(jacc), _t(wire), torch.from_numpy(w))
    for g, o, x in zip(jax.tree.leaves(_np(interop.to_numpy(got))),
                       jax.tree.leaves(_np(interop.to_numpy(oracle))),
                       jax.tree.leaves(_np(want))):
        assert g.shape == x.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, x, **AGG_TOL)
        np.testing.assert_allclose(o, x, **AGG_TOL)
    return got


def test_tree_dequant_acc_int8_scale_tree():
    """Stacked {"q", "scale"} nodes: the scale folds into the coefficient;
    nested dict/list structure walks; the accumulator mirrors the
    payload, not the wire."""
    rng = np.random.default_rng(2)
    C = 7
    payload = {"w": rng.standard_normal((C, 6, 9)).astype(np.float32),
               "sub": [rng.standard_normal((C, 11)).astype(np.float32),
                       rng.standard_normal((C,)).astype(np.float32)]}
    wire = _int8_wire(jax.tree.map(jnp.asarray, payload), 3)
    out = _check_tree(wire, np.abs(rng.standard_normal(C)).astype(np.float32))
    assert out["w"].shape == (6, 9) and out["sub"][1].shape == ()


def test_tree_dequant_acc_mixed_wire():
    """int8 nodes, fp16 and fp32 dense leaves in one wire tree, a
    zero-weight client among them."""
    rng = np.random.default_rng(3)
    C = 5
    wire = {"a": _int8_wire(jnp.asarray(
                rng.standard_normal((C, 24)).astype(np.float32)), 4),
            "b": jnp.asarray(rng.standard_normal((C, 4, 6)).astype(
                np.float16)),
            "c": jnp.asarray(rng.standard_normal((C, 3)).astype(np.float32))}
    _check_tree(wire, np.array([2.0, 0.0, 1.0, 3.0, 0.5], np.float32))


def test_tree_dequant_acc_running_accumulation():
    """Two folds over client halves equal one fold over the stack (chunk
    invariance at the kernel level), from a nonzero accumulator."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 50)).astype(np.float32)
    w = np.abs(rng.standard_normal(8)).astype(np.float32)
    acc0 = rng.standard_normal(50).astype(np.float32)
    full = _check_tree(jnp.asarray(x), w, jnp.asarray(acc0))
    half = agg.tree_dequant_acc(torch.from_numpy(acc0.copy()),
                                torch.from_numpy(x[:4]),
                                torch.from_numpy(w[:4]))
    half = agg.tree_dequant_acc(half, torch.from_numpy(x[4:]),
                                torch.from_numpy(w[4:]))
    np.testing.assert_allclose(half.numpy(), full.numpy(), **AGG_TOL)


def test_acc_zeros_like_structures():
    wire = {"q8": {"q": torch.zeros((3, 4, 5), dtype=torch.int8),
                   "scale": torch.zeros(3)},
            "dense": torch.zeros((3, 7), dtype=torch.float16)}
    acc = agg.acc_zeros_like(wire)
    want = jagg.acc_zeros_like(jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), wire))
    assert acc["q8"].shape == want["q8"].shape == (4, 5)
    assert acc["q8"].dtype == torch.float32
    assert acc["dense"].shape == want["dense"].shape == (7,)
    assert acc["dense"].dtype == torch.float32


# ------------------------------------- client-stacked FedParaMatmul

STACKED = [(3, 9, 48, 80, 5),     # test_kernel_grads.py:106
           (2, 11, 40, 56, 4)]    # test_kernel_grads.py:136
BLK = dict(interpret=True, block_b=16, block_m=32, block_n=32)


def _stacked_mats(seed, C, B, m, n, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, B, m)).astype(np.float32)
    fac = [(0.2 * rng.standard_normal((C, d, r))).astype(np.float32)
           for d in (m, n, m, n)]
    return x, fac


@pytest.mark.parametrize("C,B,m,n,r", STACKED)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_function_grads_match_reference(C, B, m, n, r, kind):
    x, fac = _stacked_mats(C * 100 + B, C, B, m, n, r)

    def loss(*a):
        y = jops.fedpara_matmul(*a, kind=kind, **BLK)
        return jnp.sum(jnp.sin(y))

    want_y = jops.fedpara_matmul(*map(jnp.asarray, (x, *fac)), kind=kind,
                                 **BLK)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray,
                                                        (x, *fac)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *fac)]
    ops.reset_launches()
    y = ops.fedpara_matmul(*ts, kind=kind)
    got = torch.autograd.grad(torch.sin(y).sum(), ts)
    assert ops.launches() == {k: 0 for k in ops.KERNELS}   # host: plain
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **GRAD_TOL)
    for g, w, nm in zip(got, want, NAMES):
        assert g.shape == w.shape, nm
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"{kind} {(C, B, m, n, r)} {nm}")


@pytest.mark.parametrize("C,B,m,n,r", STACKED)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_backward_wrappers_match_closed_form_oracle(C, B, m, n, r,
                                                            kind):
    """The wrappers the Function's backward calls on a client stack (the
    client forms of K3 and K4 on the card) and the port's oracle, against
    the reference's closed-form oracle per client."""
    x, fac = _stacked_mats(7 * C + m, C, B, m, n, r)
    dy = np.random.default_rng(B).standard_normal((C, B, n)).astype(
        np.float32)
    want = jax.vmap(lambda *a: jref.fedpara_matmul_vjp_ref(
        *a, kind=kind))(*map(jnp.asarray, (x, *fac, dy)))
    tx, tf, tdy = (torch.from_numpy(x), [torch.from_numpy(f) for f in fac],
                   torch.from_numpy(dy))
    oracle = ref.fedpara_matmul_vjp_ref(tx, *tf, tdy, kind=kind)
    dx = ops.fedpara_dx(tdy, *tf, kind=kind, out_dtype=tx.dtype)
    dx1, dx2 = ops.fedpara_dfactors(tx, tdy, *tf, side="x", kind=kind)
    dy1, dy2 = ops.fedpara_dfactors(tx, tdy, *tf, side="y", kind=kind)
    for got in (oracle, (dx, dx1, dy1, dx2, dy2)):
        for g, w, nm in zip(got, want, NAMES):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                       err_msg=f"{kind} {nm}")


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_forward_saves_no_dense_weight(kind):
    C, B, m, n, r = 3, 8, 96, 80, 6
    x, fac = _stacked_mats(5, C, B, m, n, r)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *fac)]
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ops.fedpara_matmul(*ts, kind=kind)
    assert sorted(sizes) == sorted(a.size for a in (x, *fac))
    assert C * m * n not in sizes and m * n not in sizes
    y.sum().backward()
    assert all(t.grad is not None for t in ts)


# ---------------------------------------------------- stacked tree ops

def test_stacked_tree_ops_equal_reference():
    """tree_broadcast, tree_index / tree_unstack and the masked weighted
    mean over the client axis, against the reference's ops."""
    from repro.fl import strategies as jstrat

    from repro_torch.fl import strategies

    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32)]}
    got = strategies.tree_broadcast(_t(tree), 4)
    assert _maxdiff(jstrat.tree_broadcast(tree, 4), got) == 0.0
    got["a"][0].add_(1.0)      # every client owns its copy
    assert float(got["a"][1].sub(torch.from_numpy(tree["a"])).abs().max()) \
        == 0.0
    stacked = jax.tree.map(lambda a: rng.standard_normal(
        (4, *a.shape)).astype(np.float32), tree)
    w = np.array([3.0, 0.0, 1.5, 2.0], np.float32)
    assert _maxdiff(jstrat.tree_wmean_stacked(stacked, jnp.asarray(w)),
                    strategies.tree_wmean_stacked(
                        _t(stacked), torch.from_numpy(w))) < 1e-6
    parts = strategies.tree_unstack(_t(stacked))
    want = jstrat.tree_unstack(stacked)
    assert len(parts) == len(want) == 4
    assert all(_maxdiff(wp, gp) == 0.0 for wp, gp in zip(want, parts))
    assert _maxdiff(jstrat.tree_index(stacked, 2),
                    strategies.tree_index(_t(stacked), 2)) == 0.0


# ------------------------------------------------ batched local update

def _stacked_state(name, params, C, rng):
    """C clients' reference-style states with random control variates /
    duals, stacked (the scalars mu_prox / alpha become (C,))."""
    def one():
        noise = jax.tree.map(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(
                np.float32), _np(params))
        if name == "scaffold":
            return {"c_i": noise,
                    "c": jax.tree.map(lambda a: -0.5 * a, noise)}
        if name == "feddyn":
            return {"lambda_i": noise, "alpha": np.float32(0.1)}
        if name == "fedprox":
            return {"mu_prox": np.float32(0.1)}
        return {}
    states = [one() for _ in range(C)]
    if not states[0]:
        return {}
    return jax.tree.map(lambda *xs: np.stack(xs), *states)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batched_local_update_matches_reference(strategy):
    task = get_task()
    jcfg, jparams, jloss = make_model("fedpara")
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind="fedpara", gamma=0.3,
                                       min_dim_for_factorization=8,
                                       use_kernels=True))
    cids, seeds = [2, 5, 0], [9, 4, 1]
    C = len(cids)
    batches, step_mask = jloader.stack_client_epochs(
        task["tr"], task["parts"], cids, 16, 1, seeds)
    assert len(set(step_mask.sum(1).tolist())) > 1   # masked steps happen
    rng = np.random.default_rng(3)
    # every client starts from its own params, as personalization gives
    stacked = jax.tree.map(
        lambda a: np.stack([np.asarray(a) * (1 + 0.05 * c)
                            for c in range(C)]), _np(jparams))
    state = _stacked_state(strategy, jparams, C, rng)
    ccfg = dict(lr=0.1, batch=16, epochs=1, momentum=0.5,
                weight_decay=1e-3)
    want = jbatch.batched_local_update(
        jax.tree.map(jnp.asarray, stacked), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, batches), jnp.asarray(step_mask), jloss,
        jclient.ClientConfig(**ccfg), strategy, jnp.float32(0.1))
    got = batch_engine.batched_local_update(
        _t(stacked), _t(state), {k: torch.from_numpy(v)
                                 for k, v in batches.items()},
        torch.from_numpy(step_mask),
        lambda p, b: rec.mlp_loss_clients(p, cfg, b),
        client.ClientConfig(**ccfg), strategy, 0.1)
    for w, g, nm in zip(want, got, ("params", "state", "last_loss",
                                    "n_steps")):
        assert _maxdiff(w, g) < DEFAULT_ATOL, nm


# ------------------------------------------------------------ FLServer

_REF_RUNS = {}


def _eval_task():
    te = get_task()["te"]
    return {"x": te["x"][:200], "y": te["y"][:200]}


def _ref_run(engine, personalization, strategy, **server_kw):
    """One reference run (cached: the plain and kernel cases, and the
    port's batched and streaming comparisons, share it)."""
    key = (engine, personalization, strategy,
           tuple(sorted(server_kw.items())))
    if key not in _REF_RUNS:
        kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
        jcfg, params, loss_fn = make_model(kind)
        ev = _eval_task()
        srv = JFLServer(loss_fn, params, get_task()["tr"], get_task()["parts"],
                        jmake_strategy(strategy),
                        jclient.ClientConfig(lr=0.1, batch=16, epochs=1),
                        JServerConfig(clients=N_CLIENTS, participation=0.5,
                                      rounds=3, engine=engine,
                                      personalization=personalization,
                                      **server_kw),
                        eval_fn=lambda p: float(jrec.mlp_accuracy(p, jcfg,
                                                                  ev)))
        srv.run()
        _REF_RUNS[key] = srv
    return _REF_RUNS[key]


def _port_run(engine, personalization, strategy, use_kernels, **server_kw):
    kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
    _, jparams, _ = make_model(kind)
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8,
                                       use_kernels=use_kernels))
    ev = {k: torch.from_numpy(v) for k, v in _eval_task().items()}
    srv = FLServer(lambda p, b: rec.mlp_loss(p, cfg, b), _t(jparams),
                   get_task()["tr"], get_task()["parts"],
                   make_strategy(strategy),
                   client.ClientConfig(lr=0.1, batch=16, epochs=1),
                   ServerConfig(clients=N_CLIENTS, participation=0.5,
                                rounds=3, engine=engine,
                                personalization=personalization,
                                **server_kw),
                   eval_fn=lambda p: float(rec.mlp_accuracy(p, cfg, ev)),
                   device="cpu",
                   loss_fn_clients=lambda p, b: rec.mlp_loss_clients(p, cfg,
                                                                     b))
    srv.run()
    return srv


def _assert_same_run(ref_srv, srv):
    """Masks bitwise, bytes and comm_log exact, records with the same
    keys; loss, eval, params, server state, client states and residents
    within 1e-4."""
    assert len(srv.history) == len(ref_srv.history) == 3
    for r, g in zip(ref_srv.history, srv.history):
        assert sorted(g) == sorted(r)
        for k in ("arrived_mask", "sampled", "participants", "down_bytes",
                  "up_bytes", "comm_gb", "round", "nonfinite_losses",
                  "chunks", "client_chunk"):
            assert g.get(k) == r.get(k), k
        assert abs(g["mean_loss"] - r["mean_loss"]) < DEFAULT_ATOL
        assert abs(g["eval"] - r["eval"]) < DEFAULT_ATOL
    assert (srv.comm_log.up_bytes, srv.comm_log.down_bytes,
            srv.comm_log.rounds) == (ref_srv.comm_log.up_bytes,
                                     ref_srv.comm_log.down_bytes,
                                     ref_srv.comm_log.rounds)
    assert _maxdiff(ref_srv.global_params, srv.global_params) < DEFAULT_ATOL
    assert _maxdiff(ref_srv.server_state, srv.server_state) < DEFAULT_ATOL
    assert sorted(srv.client_states) == sorted(ref_srv.client_states)
    for cid in ref_srv.client_states:
        assert _maxdiff(ref_srv.client_states[cid],
                        srv.client_state_of(cid)) < DEFAULT_ATOL
    assert sorted(srv.local_trees) == sorted(ref_srv.local_trees)
    for cid in ref_srv.local_trees:
        assert _maxdiff(ref_srv.local_trees[cid],
                        srv.resident_of(cid)) < DEFAULT_ATOL


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("strategy", ["fedavg", "scaffold"])
@pytest.mark.parametrize("personalization", ["none", "pfedpara"])
def test_batched_server_matches_reference(personalization, strategy,
                                          use_kernels):
    _assert_same_run(_ref_run("batched", personalization, strategy),
                     _port_run("batched", personalization, strategy,
                               use_kernels))


@pytest.mark.parametrize("personalization,strategy,server_kw", [
    ("fedper", "fedavg", {}),
    ("local", "fedavg", {}),
    ("none", "feddyn", {"dropout_prob": 0.3, "oversample": 0.5}),
    ("none", "fedadam", {"dropout_prob": 0.3, "oversample": 0.5}),
], ids=["fedper", "local", "feddyn-stragglers", "fedadam-stragglers"])
def test_batched_server_other_modes_match_reference(personalization,
                                                    strategy, server_kw):
    ref_srv = _ref_run("batched", personalization, strategy, **server_kw)
    if server_kw:   # stragglers: some sampled clients must not arrive
        assert any(0 in r["arrived_mask"] for r in ref_srv.history)
    _assert_same_run(ref_srv, _port_run("batched", personalization,
                                        strategy, True, **server_kw))


@pytest.mark.parametrize("chunk", [1, 3, N_CLIENTS])
def test_streaming_server_matches_reference_and_batched(chunk):
    """Every chunking matches the reference's streaming engine at the
    same chunk and the port's own batched run (chunking reassociates
    the fp32 weighted sum only); N_CLIENTS clamps to the whole cohort."""
    srv = _port_run("streaming", "none", "fedavg", True, client_chunk=chunk)
    _assert_same_run(_ref_run("streaming", "none", "fedavg",
                              client_chunk=chunk), srv)
    batched = _port_run("batched", "none", "fedavg", True)
    assert [r["arrived_mask"] for r in srv.history] == \
        [r["arrived_mask"] for r in batched.history]
    assert _maxdiff(interop.to_numpy(batched.global_params),
                    srv.global_params) < DEFAULT_ATOL
    want_chunk = min(chunk, srv.history[0]["participants"])
    assert all(r["client_chunk"] == want_chunk for r in srv.history)


@pytest.mark.parametrize("personalization,strategy", [
    ("pfedpara", "scaffold"), ("fedper", "fedprox"), ("none", "feddyn")])
def test_streaming_server_modes_match_reference(personalization, strategy):
    """Pad slots (4 clients in chunks of 3) carry client 0's state and
    residents, zero batches and weight 0; the personalization residents
    and strategy states thread through the chunks."""
    _assert_same_run(
        _ref_run("streaming", personalization, strategy, client_chunk=3),
        _port_run("streaming", personalization, strategy, True,
                  client_chunk=3))


def test_engines_need_a_client_stacked_loss_and_identity_codec_hooks():
    """The batched and streaming engines train through an explicit
    client-stacked loss; the identity codec's aggregation hooks hand the
    wire and the mean through, as the reference's do."""
    from repro.fl.codecs import make_codec as jmake_codec

    from repro_torch.fl.codecs import make_codec

    _, jparams, _ = make_model("fedpara")
    for engine in ("batched", "streaming"):
        with pytest.raises(ValueError, match="loss_fn_clients"):
            FLServer(lambda p, b: 0.0, _t(jparams), get_task()["tr"],
                     get_task()["parts"], make_strategy("fedavg"),
                     client.ClientConfig(), ServerConfig(engine=engine),
                     device="cpu")
    jc, c = jmake_codec(""), make_codec("")
    payload = _t(jparams)
    assert c.agg_linear is jc.agg_linear is True
    wire, ef = c.encode_for_agg(payload, ref=payload)
    assert wire is payload and ef is None
    assert c.agg_finalize(payload, ref=payload) is payload
    assert _maxdiff(jc.agg_finalize(jparams, ref=jparams), payload) == 0.0


# ----------------------------------------------------------------- CLI

_CLI = {}   # the reference CLI's records, shared by the kernel cases


def _reference_cli_record(argv):
    """The reference CLI's final record, from a fresh process on the one
    host device, as a user runs it. The reference's batched and
    streaming CLI builds a ("clients",) mesh over every visible device,
    and a test process may see many host devices: importing
    ``repro.launch.dryrun`` (as another test module does) sets
    XLA_FLAGS before the backend starts."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", "repro.launch.train", *argv],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    return json.loads(out[out.rindex("\n{\n") + 1:])


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("engine", [["--engine", "batched"],
                                    ["--engine", "streaming",
                                     "--client-chunk", "3"]],
                         ids=["batched", "streaming"])
def test_train_cli_engines_match_reference_record(tmp_path, engine,
                                                  use_kernels):
    jcfg = jrec.MLPConfig(in_dim=784, hidden=256, classes=10,
                          param=JParamCfg(kind="fedpara", gamma=0.3,
                                          min_dim_for_factorization=8))
    params = _np(jrec.init_mlp_model(jax.random.PRNGKey(0), jcfg))
    path = str(tmp_path / "init.npz")
    interop.save_npz(params, path)
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "2", "--lr",
            "0.05", *engine]
    key = tuple(engine)
    if key not in _CLI:
        _CLI[key] = _reference_cli_record(argv)
    want = _CLI[key]
    extra = ["--device", "cpu", "--init-params", path]
    got = train.main(argv + extra + (["--use-kernels"] if use_kernels
                                     else []))["record"]
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        if k in ("mean_loss", "eval"):
            assert abs(got[k] - want[k]) < DEFAULT_ATOL, k
        else:
            assert got[k] == want[k], k


def test_train_cli_defaults_to_the_batched_engine():
    args = train.parser().parse_args(["--mode", "fl"])
    assert (args.engine, args.client_chunk) == ("batched", 16)
    with pytest.raises(NotImplementedError, match="A12"):
        train.main(["--mode", "fl", "--rounds", "1", "--engine", "async",
                    "--device", "cpu"])
