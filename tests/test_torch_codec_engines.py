"""The port's three FL engines under every codec stage, held against the
reference's on the CPU: 3 rounds of ``tests/parity.py``'s MLP on its
task, the reference's int8 noise injected through
``FLServer(quant_noise=...)`` (drawn with jax exactly as the reference
draws it, ``test_torch_codecs.jax_noise``).

The oracle has two layers. Always: masks and sampled clients bit for
bit, ``up_bytes`` / ``down_bytes`` / ``comm_gb`` and the run's byte
totals exact. Codecs that neither round nor select (``delta``,
``delta|lowrank0.25``, downlink ``delta`` or identity): parameters,
loss and eval within ``DEFAULT_ATOL`` = 1e-4 (``tests/parity.py:54``),
as for the identity codec. Codecs that round or select (int8, fp16,
top-k): the port's training differs from the reference's in the last
bits, and a quantizer or a top-k selection turns such a difference into
a whole quantization step or a swapped entry, so each global leaf is
held within 1e-3 relative Frobenius norm and each round's mean loss
within 1e-3 relative, while the identity-codec run of the same engine
holds 1e-4 in the same test, so the looser bound is the codec's.
"""
import numpy as np
import pytest
import torch

import jax
from parity import DEFAULT_ATOL, N_CLIENTS, get_task, make_model
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.fl import client as jclient
from repro.fl import make_strategy as jmake_strategy
from repro.nn import recurrent as jrec
from test_torch_codecs import jax_noise

from repro_torch import interop
from repro_torch.configs.base import ParamCfg
from repro_torch.fl import client
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.kernels import ops
from repro_torch.nn import recurrent as rec

ROUND_REL = 1e-3     # rounding / selecting codecs: relative, per leaf
CHUNK = {"client_chunk": 3}   # 4 clients a round: 2 chunks, one pad slot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _eval_task():
    te = get_task()["te"]
    return {"x": te["x"][:200], "y": te["y"][:200]}


def _kw(engine):
    return CHUNK if engine == "streaming" else {}


_REF = {}


def _ref_run(engine, up, down, personalization="none"):
    key = (engine, up, down, personalization)
    if key not in _REF:
        kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
        jcfg, params, loss_fn = make_model(kind)
        ev = _eval_task()
        srv = JFLServer(loss_fn, params, get_task()["tr"],
                        get_task()["parts"], jmake_strategy("fedavg"),
                        jclient.ClientConfig(lr=0.1, batch=16, epochs=1),
                        JServerConfig(clients=N_CLIENTS, participation=0.5,
                                      rounds=3, engine=engine,
                                      personalization=personalization,
                                      uplink_codec=up, downlink_codec=down,
                                      **_kw(engine)),
                        eval_fn=lambda p: float(jrec.mlp_accuracy(p, jcfg,
                                                                  ev)))
        srv.run()
        _REF[key] = srv
    return _REF[key]


def _port_run(engine, up, down, personalization="none", use_kernels=True,
              rounds=3, run=True, **kw):
    kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
    _, jparams, _ = make_model(kind)
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8,
                                       use_kernels=use_kernels))
    ev = {k: torch.from_numpy(v) for k, v in _eval_task().items()}
    srv = FLServer(lambda p, b: rec.mlp_loss(p, cfg, b),
                   interop.from_jax_params(jax.tree.map(np.asarray, jparams)),
                   get_task()["tr"], get_task()["parts"],
                   make_strategy("fedavg"),
                   client.ClientConfig(lr=0.1, batch=16, epochs=1),
                   ServerConfig(clients=N_CLIENTS, participation=0.5,
                                rounds=rounds, engine=engine,
                                personalization=personalization,
                                uplink_codec=up, downlink_codec=down,
                                **{**_kw(engine), **kw}),
                   eval_fn=lambda p: float(rec.mlp_accuracy(p, cfg, ev)),
                   device="cpu",
                   loss_fn_clients=lambda p, b: rec.mlp_loss_clients(p, cfg,
                                                                     b),
                   quant_noise=jax_noise)
    if run:
        srv.run()
    return srv


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(
        jax.tree.map(np.asarray, tree))]


def _assert_exact_records(ref, srv):
    assert len(srv.history) == len(ref.history) == 3
    for r, g in zip(ref.history, srv.history):
        assert sorted(g) == sorted(r)
        for k in ("arrived_mask", "sampled", "participants", "down_bytes",
                  "up_bytes", "comm_gb", "round", "chunks", "client_chunk"):
            assert g.get(k) == r.get(k), k
    assert (srv.comm_log.up_bytes, srv.comm_log.down_bytes) == \
        (ref.comm_log.up_bytes, ref.comm_log.down_bytes)


def _assert_tight(ref, srv):
    """The non-rounding oracle: 1e-4 on loss, eval and parameters."""
    _assert_exact_records(ref, srv)
    for r, g in zip(ref.history, srv.history):
        assert abs(g["mean_loss"] - r["mean_loss"]) < DEFAULT_ATOL
        assert abs(g["eval"] - r["eval"]) < DEFAULT_ATOL
    for a, b in zip(_leaves(ref.global_params),
                    _leaves(interop.to_numpy(srv.global_params))):
        assert np.abs(a - b).max() < DEFAULT_ATOL


def _assert_rounding(ref, srv, what):
    """The rounding oracle: each leaf within 1e-3 relative Frobenius,
    each round's mean loss within 1e-3 relative."""
    _assert_exact_records(ref, srv)
    for r, g in zip(ref.history, srv.history):
        assert abs(g["mean_loss"] - r["mean_loss"]) <= \
            ROUND_REL * abs(r["mean_loss"]), (what, r["round"])
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(_leaves(ref.global_params),
                    _leaves(interop.to_numpy(srv.global_params))):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, float(np.abs(a - b).max()))
        assert rel <= ROUND_REL, (what, rel)
    print(f"{what}: max |param diff| {worst_abs:.3e}, max relative "
          f"Frobenius {worst_rel:.3e}")


# ----------------------------------------------- codecs that neither round
# nor select: the engines' own tolerance

@pytest.mark.parametrize("engine,up,down", [
    ("sequential", "delta|lowrank0.25", "delta"),
    ("batched", "delta", ""),
    ("batched", "delta|lowrank0.25", "delta"),
    ("streaming", "delta|lowrank0.25", "delta"),
    ("streaming", "delta", "delta"),
])
def test_lossless_codec_runs_match_reference(engine, up, down):
    _assert_tight(_ref_run(engine, up, down), _port_run(engine, up, down))


# -------------------------------- codecs that round or select: 1e-3 rel

@pytest.mark.parametrize("engine,up,down,personalization", [
    ("sequential", "delta|topk0.1|int8", "delta|int8", "none"),
    ("batched", "delta|topk0.1|int8", "delta|topk0.5|fp16", "none"),
    ("batched", "int8", "", "pfedpara"),
    ("streaming", "delta|topk0.1|int8", "fp16", "none"),
    ("streaming", "fp16", "delta|int8", "none"),
    ("streaming", "fp16", "", "pfedpara"),
])
def test_rounding_codec_runs_match_reference(engine, up, down,
                                             personalization):
    _assert_tight(_ref_run(engine, "", "", personalization),
                  _port_run(engine, "", "", personalization))
    srv = _port_run(engine, up, down, personalization)
    _assert_rounding(_ref_run(engine, up, down, personalization), srv,
                     f"{engine} {up!r}/{down!r} {personalization}")
    assert srv.comm_log.up_bytes < _port_run(
        engine, "", "", personalization).comm_log.up_bytes


def test_streaming_folds_int8_and_fp16_wire_through_k7(monkeypatch):
    """The streaming engine hands K7's wrapper the codec's wire at its
    wire width: int8 ``{"q", "scale"}`` nodes and fp16 leaves; a
    low-rank uplink arrives decoded per client, in fp32 (the host takes
    the plain version, which counts no launch, so the wrapper is
    spied)."""
    seen = []
    orig = ops.dequant_acc

    def spy(acc, q, coeff):
        seen.append(q.dtype)
        return orig(acc, q, coeff)

    monkeypatch.setattr(ops, "dequant_acc", spy)
    for up, want in (("delta|topk0.1|int8", {torch.int8}),
                     ("fp16", {torch.float16}),
                     ("delta|lowrank0.25", {torch.float32})):
        seen.clear()
        _port_run("streaming", up, "", rounds=1)
        assert set(seen) == want, up


def test_engines_agree_with_each_other_under_an_ef_codec():
    """Sequential, batched and streaming (chunks of 1 and 3) on one EF
    codec: the same noise positions give the same records and, within
    the rounding bound, the same model."""
    up, down = "delta|topk0.1|int8", "delta|int8"
    runs = {e: _port_run(e, up, down)
            for e in ("sequential", "batched", "streaming")}
    runs["streaming1"] = _port_run("streaming", up, down, client_chunk=1)
    for name, srv in runs.items():
        _assert_rounding_pair(runs["batched"], srv, name)


def _assert_rounding_pair(a, b, what):
    for ra, rb in zip(a.history, b.history):
        for k in ("arrived_mask", "sampled", "down_bytes", "up_bytes"):
            assert ra[k] == rb[k], (what, k)
        assert abs(ra["mean_loss"] - rb["mean_loss"]) <= \
            ROUND_REL * abs(ra["mean_loss"]), what
    for x, y in zip(_leaves(interop.to_numpy(a.global_params)),
                    _leaves(interop.to_numpy(b.global_params))):
        assert np.linalg.norm(x - y) <= ROUND_REL * np.linalg.norm(x), what


def test_ef_state_and_downlink_state_live_where_the_reference_keeps_them():
    """``_ef_up`` in every arrived client's state (stacked-engine rows
    included) and the server's ``_down_ref`` / ``_down_ef``, shaped as the
    reference's, and close to them."""
    up, down = "delta|topk0.1|int8", "delta|topk0.5|fp16"
    ref = _ref_run("batched", up, down)
    srv = _port_run("batched", up, down)
    assert sorted(srv.client_states) == sorted(ref.client_states)
    for cid, st in ref.client_states.items():
        mine = srv.client_state_of(cid)
        assert sorted(mine) == sorted(st) == ["_ef_up"]
        for a, b in zip(_leaves(st["_ef_up"]),
                        _leaves(interop.to_numpy(mine["_ef_up"]))):
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= 5e-2 * max(np.linalg.norm(a),
                                                       1e-6)
    for name in ("_down_ref", "_down_ef"):
        for a, b in zip(_leaves(getattr(ref, name)),
                        _leaves(interop.to_numpy(getattr(srv, name)))):
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= ROUND_REL * max(
                np.linalg.norm(a), 1e-6) + 1e-6, name


def test_default_noise_depends_on_round_and_position_only():
    """Without the hook each position draws from a generator seeded from
    (round, position): batched and streaming quantize alike, and a
    second run repeats the first bit for bit."""
    kw = dict(up="delta|topk0.1|int8", down="delta|int8")
    runs = []
    for engine in ("batched", "streaming", "batched"):
        srv = _port_run(engine, run=False, **kw)
        srv.quant_noise = None
        srv.run()
        runs.append(srv)
    _assert_rounding_pair(runs[0], runs[1], "streaming vs batched")
    a, b = (interop.to_numpy(s.global_params) for s in (runs[0], runs[2]))
    assert all(x.tobytes() == y.tobytes()
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    like = {"w": torch.zeros(1000)}
    noise = runs[0]._draw_noise(5, like)["w"]
    assert float(noise.min()) >= -0.5 and float(noise.max()) < 0.5
    assert torch.equal(noise, runs[0]._draw_noise(5, like)["w"])
    assert not torch.equal(noise, runs[0]._draw_noise(6, like)["w"])
