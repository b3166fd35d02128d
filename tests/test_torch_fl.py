"""The port's FL training path held against the reference on the CPU:
the copied numpy modules bit for bit (dataset, partitions, local-epoch
order, arrival masks, data seeds), one ``local_update`` per strategy,
the sequential ``FLServer`` on ``tests/parity.py``'s task, and the
training CLI record for record. Tolerances are the reference's:
``DEFAULT_ATOL = 1e-4`` for parameters, losses and eval
(``tests/parity.py:54``); masks and wire bytes exact. Both sides start
from the parameters the reference initialized (``jax.random`` and torch
draw different numbers from one seed).
"""
import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from parity import DEFAULT_ATOL, N_CLIENTS, get_task, make_model
from repro.configs.base import ParamCfg as JParamCfg
from repro.core import parameterization as jpar
from repro.data import loader as jloader
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.fl import arrivals as jarrivals
from repro.fl import client as jclient
from repro.fl import make_strategy as jmake_strategy
from repro.fl import trace as jtrace
from repro.fl.codecs import make_codec as jmake_codec
from repro.launch import train as jtrain
from repro.nn import recurrent as jrec

from repro_torch import interop
from repro_torch.configs.base import ParamCfg
from repro_torch.core import parameterization as par
from repro_torch.data import loader, partition, synthetic
from repro_torch.fl import arrivals, client, codecs, trace
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.launch import train
from repro_torch.nn import recurrent as rec

STRATEGIES = ["fedavg", "fedprox", "scaffold", "feddyn", "fedadam"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _maxdiff(a, b):
    """Largest |a - b| over two trees (reference numpy / port tensors)."""
    a, b = _np(a), _np(interop.to_numpy(b))
    leaves = jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.abs(np.asarray(x, np.float64)
                                  - np.asarray(y, np.float64)).max()), a, b))
    return max(leaves) if leaves else 0.0


# ------------------------------------------------- copied numpy modules

def test_dataset_and_split_equal_reference_bitwise():
    want = jsynthetic.make_image_dataset(300, 10, size=12, channels=2,
                                         noise=0.4, seed=3)
    got = synthetic.make_image_dataset(300, 10, size=12, channels=2,
                                       noise=0.4, seed=3)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    for a, b in zip(jsynthetic.train_test_split(want, seed=1),
                    synthetic.train_test_split(got, seed=1)):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("seed", [0, 5])
def test_partitions_equal_reference_bitwise(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 500).astype(np.int32)
    for want, got in ((jpartition.dirichlet_partition(labels, 9, 0.5, seed),
                       partition.dirichlet_partition(labels, 9, 0.5, seed)),
                      (jpartition.iid_partition(500, 7, seed),
                       partition.iid_partition(500, 7, seed))):
        assert len(want) == len(got)
        assert all(w.dtype == g.dtype and w.tobytes() == g.tobytes()
                   for w, g in zip(want, got))


@pytest.mark.parametrize("seed", [7, 2 ** 40 + 3])
def test_client_epochs_order_equals_reference(seed):
    data = {"x": np.arange(90, dtype=np.float32).reshape(45, 2),
            "y": np.arange(45, dtype=np.int32)}
    for idx in (np.arange(3, 40), np.arange(5)):   # normal and tiny client
        want = list(jloader.client_epochs(data, idx, 8, 3, seed))
        got = list(loader.client_epochs(data, idx, 8, 3, seed))
        assert len(got) == len(want) == loader.client_step_count(
            len(idx), 8, 3)
        assert all(g[k].tobytes() == w[k].tobytes()
                   for g, w in zip(got, want) for k in w)


def test_arrival_mask_and_seeds_equal_reference():
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        lat = rng.lognormal(size=n).round(1)     # ties on purpose
        ok = rng.random(n) > 0.3
        k = int(rng.integers(1, n + 1))
        want = jarrivals.arrival_mask(ok, lat, k)
        got = arrivals.arrival_mask(ok, lat, k)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert arrivals.arrival_events(want, lat, 2.5) == \
            jarrivals.arrival_events(want, lat, 2.5)
        crash = rng.random(n) > 0.5
        assert arrivals.fold_crashes(want, crash).tobytes() == \
            jarrivals.fold_crashes(want, crash).tobytes()
    for seed, rnd, n in ((0, 0, 5), (3, 17, 40)):
        assert trace.spawn_seeds(seed, rnd, n).tobytes() == \
            jtrace.spawn_seeds(seed, rnd, n).tobytes()


@pytest.mark.parametrize("kind", ["fedpara", "pfedpara"])
def test_mlp_init_matches_reference_layout_and_counts(kind):
    jcfg = jrec.MLPConfig(in_dim=784, hidden=256, classes=10,
                          param=JParamCfg(kind=kind, gamma=0.3,
                                          min_dim_for_factorization=8))
    cfg = rec.MLPConfig(in_dim=784, hidden=256, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8))
    want = _np(jrec.init_mlp_model(jax.random.PRNGKey(0), jcfg))
    got = rec.init_mlp_model(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(np.shape, want) == jax.tree.map(
        np.shape, interop.to_numpy(got))
    assert got["fc1"]["x1"].shape == (784, 40)
    assert got["fc2"]["y1"].shape == (10, 4)
    assert par.num_params(got) == jpar.num_params(want)
    for k in ("x1", "y2"):   # same init law, other random numbers
        ratio = float(got["fc1"][k].std()) / float(want["fc1"][k].std())
        assert abs(ratio - 1) < 0.05, (k, ratio)


def test_codec_is_identity_only_and_prices_bytes_exactly():
    """The identity specs give the identity codec; every other stage
    parses as the reference's does (``tests/test_torch_codecs.py`` holds
    the stages themselves) and prices the MLP's bytes exactly."""
    for spec in ("", "fp32", "none", "identity"):
        c = codecs.make_codec(spec)
        assert c.is_identity and not c.has_ef and not c.has_delta
    _, params, _ = make_model("fedpara")
    for spec in ("", "int8", "delta|topk0.1|int8", "fp16"):
        c, jc = codecs.make_codec(spec), jmake_codec(spec)
        assert [(st.kind, st.param) for st in c.stages] == \
            [(st.kind, st.param) for st in jc.stages]
        assert (c.has_ef, c.has_delta) == (jc.has_ef, jc.has_delta)
        assert c.wire_bytes(interop.from_jax_params(_np(params))) == \
            jc.wire_bytes(params), spec


# ------------------------------------------------------- local update

def _client_state(name, params, rng):
    """The reference's init state, with random control variates / duals
    so the correction terms are exercised."""
    noise = jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        _np(params))
    if name == "scaffold":
        return {"c_i": noise, "c": jax.tree.map(lambda a: -0.5 * a, noise)}
    if name == "feddyn":
        return {"lambda_i": noise, "alpha": np.float32(0.1)}
    if name == "fedprox":
        return {"mu_prox": np.float32(0.1)}
    return {}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_local_update_matches_reference(strategy):
    task = get_task()
    jcfg, jparams, jloss = make_model("fedpara")
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind="fedpara", gamma=0.3,
                                       min_dim_for_factorization=8))
    state = _client_state(strategy, jparams, np.random.default_rng(1))
    idx = task["parts"][2]
    ccfg = dict(lr=0.1, batch=16, epochs=1)
    want_p, want_s, want_m = jclient.local_update(
        jparams, jloader.client_epochs(task["tr"], idx, 16, 1, 9), jloss,
        jclient.ClientConfig(**ccfg), jmake_strategy(strategy),
        client_state=jax.tree.map(jax.numpy.asarray, state), lr=0.1)
    got_p, got_s, got_m = client.local_update(
        interop.from_jax_params(_np(jparams)),
        loader.client_epochs(task["tr"], idx, 16, 1, 9),
        lambda p, b: rec.mlp_loss(p, cfg, b), client.ClientConfig(**ccfg),
        make_strategy(strategy),
        client_state=interop.from_jax_params(state), lr=0.1)
    assert got_m["steps"] == want_m["steps"] > 0
    assert abs(got_m["loss"] - want_m["loss"]) < DEFAULT_ATOL
    assert _maxdiff(want_p, got_p) < DEFAULT_ATOL
    assert _maxdiff(want_s, got_s) < DEFAULT_ATOL


# ------------------------------------------------------------ FLServer

_REF_RUNS = {}


def _eval_task():
    te = get_task()["te"]
    return {"x": te["x"][:200], "y": te["y"][:200]}


def _ref_run(personalization, strategy, **server_kw):
    """One reference sequential run (cached: the plain and kernel cases
    share it)."""
    key = (personalization, strategy, tuple(sorted(server_kw.items())))
    if key not in _REF_RUNS:
        kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
        jcfg, params, loss_fn = make_model(kind)
        ev = _eval_task()
        srv = JFLServer(loss_fn, params, get_task()["tr"], get_task()["parts"],
                        jmake_strategy(strategy),
                        jclient.ClientConfig(lr=0.1, batch=16, epochs=1),
                        JServerConfig(clients=N_CLIENTS, participation=0.5,
                                      rounds=3, engine="sequential",
                                      personalization=personalization,
                                      **server_kw),
                        eval_fn=lambda p: float(jrec.mlp_accuracy(p, jcfg,
                                                                  ev)))
        srv.run()
        _REF_RUNS[key] = srv
    return _REF_RUNS[key]


def _check_server(personalization, strategy, use_kernels, **server_kw):
    """Run the port's FLServer on the parity task and hold it to the
    reference run with the same settings."""
    ref = _ref_run(personalization, strategy, **server_kw)
    kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
    jcfg, jparams, _ = make_model(kind)
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8,
                                       use_kernels=use_kernels))
    ev = {k: torch.from_numpy(v) for k, v in _eval_task().items()}
    srv = FLServer(lambda p, b: rec.mlp_loss(p, cfg, b),
                   interop.from_jax_params(_np(jparams)), get_task()["tr"],
                   get_task()["parts"], make_strategy(strategy),
                   client.ClientConfig(lr=0.1, batch=16, epochs=1),
                   ServerConfig(clients=N_CLIENTS, participation=0.5,
                                rounds=3, personalization=personalization,
                                **server_kw),
                   eval_fn=lambda p: float(rec.mlp_accuracy(p, cfg, ev)),
                   device="cpu")
    srv.run()
    assert len(srv.history) == len(ref.history) == 3
    for r, g in zip(ref.history, srv.history):
        assert g["arrived_mask"] == r["arrived_mask"]
        assert g["sampled"] == r["sampled"]
        assert (g["down_bytes"], g["up_bytes"]) == (r["down_bytes"],
                                                   r["up_bytes"])
        assert g["comm_gb"] == r["comm_gb"]
        assert abs(g["mean_loss"] - r["mean_loss"]) < DEFAULT_ATOL
        assert abs(g["eval"] - r["eval"]) < DEFAULT_ATOL
    assert (srv.comm_log.up_bytes, srv.comm_log.down_bytes,
            srv.comm_log.rounds) == (ref.comm_log.up_bytes,
                                     ref.comm_log.down_bytes,
                                     ref.comm_log.rounds)
    assert _maxdiff(ref.global_params, srv.global_params) < DEFAULT_ATOL
    assert _maxdiff(ref.server_state, srv.server_state) < DEFAULT_ATOL
    assert sorted(srv.client_states) == sorted(ref.client_states)
    for cid in ref.client_states:
        assert _maxdiff(ref.client_states[cid],
                        srv.client_state_of(cid)) < DEFAULT_ATOL
    assert sorted(srv.local_trees) == sorted(ref.local_trees)
    for cid in ref.local_trees:
        assert _maxdiff(ref.local_trees[cid],
                        srv.resident_of(cid)) < DEFAULT_ATOL
    jev = _eval_task()
    want = ref.personalized_eval(
        lambda p, cid: float(jrec.mlp_accuracy(p, jcfg, jev)))
    got = srv.personalized_eval(
        lambda p, cid: float(rec.mlp_accuracy(p, cfg, ev)))
    assert np.abs(np.subtract(got, want)).max() < DEFAULT_ATOL


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("strategy", ["fedavg", "scaffold"])
@pytest.mark.parametrize("personalization", ["none", "pfedpara"])
def test_fl_server_matches_reference(personalization, strategy, use_kernels):
    _check_server(personalization, strategy, use_kernels)


@pytest.mark.parametrize("personalization,strategy,server_kw", [
    ("fedper", "fedavg", {}),
    ("local", "fedavg", {}),
    ("none", "fedadam", {"staleness_mix": 0.5}),
    ("none", "feddyn", {"dropout_prob": 0.3, "oversample": 0.5}),
], ids=["fedper", "local", "fedadam-staleness_mix", "feddyn-stragglers"])
def test_fl_server_other_modes_match_reference(personalization, strategy,
                                               server_kw):
    _check_server(personalization, strategy, True, **server_kw)


def test_fl_server_refuses_what_is_not_ported():
    _, jparams, _ = make_model("fedpara")
    params = interop.from_jax_params(_np(jparams))
    args = (lambda p, b: 0.0, params, get_task()["tr"], get_task()["parts"],
            make_strategy("fedavg"), client.ClientConfig())
    for kw, item in (({"engine": "async"}, "A3"),
                     ({"state_store": "arena", "engine": "batched"}, "A4"),
                     ({"data_stream": "chunked", "engine": "streaming"},
                      "A4"),
                     ({"gamma_tiers": (0.1, 0.3)}, "A5"),
                     ({"defense": "clip"}, "A5"),
                     ({"recover_retries": 1}, "A5")):
        with pytest.raises(NotImplementedError, match=item):
            FLServer(*args, ServerConfig(**kw), device="cpu")
    # codecs are ported: an int8 uplink (the spec or the legacy field)
    # builds the reference's codec and charges the reference's bytes
    for kw in ({"uplink_codec": "int8"}, {"uplink_quant": "int8"}):
        srv = FLServer(*args, ServerConfig(**kw), device="cpu")
        ref = JFLServer(lambda p, b: 0.0, jparams, get_task()["tr"],
                        get_task()["parts"], jmake_strategy("fedavg"),
                        jclient.ClientConfig(), JServerConfig(**kw))
        assert srv.uplink_codec.spec == ref.uplink_codec.spec == "int8"
        assert srv.uplink_codec.wire_bytes(params) == \
            ref.uplink_codec.wire_bytes(jparams)


# ----------------------------------------------------------------- CLI

_CLI = {}   # the reference CLI's record, shared by both cases


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_train_cli_matches_reference_record(tmp_path, use_kernels):
    jcfg = jrec.MLPConfig(in_dim=784, hidden=256, classes=10,
                          param=JParamCfg(kind="fedpara", gamma=0.3,
                                          min_dim_for_factorization=8))
    params = _np(jrec.init_mlp_model(jax.random.PRNGKey(0), jcfg))
    path = str(tmp_path / "init.npz")
    interop.save_npz(params, path)
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "2",
            "--engine", "sequential", "--lr", "0.05"]
    if "want" not in _CLI:
        buf, old = io.StringIO(), sys.argv
        try:
            sys.argv = ["train"] + argv
            with contextlib.redirect_stdout(buf):
                jtrain.main()
        finally:
            sys.argv = old
        out = buf.getvalue()
        _CLI["want"] = json.loads(out[out.rindex("\n{\n") + 1:])
    want = _CLI["want"]
    extra = ["--device", "cpu", "--init-params", path]
    got = train.main(argv + extra + (["--use-kernels"] if use_kernels
                                     else []))["record"]
    assert sorted(got) == sorted(want)
    for k in ("participants", "sampled", "arrived_mask", "down_bytes",
              "up_bytes", "comm_gb", "comm_up_mb", "comm_down_mb", "round",
              "lr", "round_latency", "nonfinite_losses"):
        assert got[k] == want[k], k
    for k in ("mean_loss", "eval"):
        assert abs(got[k] - want[k]) < DEFAULT_ATOL, k

