"""The port's checkpoints held against the reference on the CPU.

* The manifest codec (``repro_torch.checkpoint.manifest``) against
  ``msgpack`` both ways, byte for byte, on every length and width class
  and on a real server's ``extra`` (RNG state, history, comm totals).
* The on-disk format both ways: a port checkpoint restored by the
  reference's ``CheckpointManager.restore_items`` and a reference
  checkpoint (a real reference server's) by the port's, bit for bit;
  a port ``FLServer`` restored from the reference server's checkpoint
  holds its state bitwise and continues it (masks bitwise, params
  within ``DEFAULT_ATOL = 1e-4``, ``tests/parity.py:54``).
* The manager's contracts, mirrored from ``tests/test_fl_resume.py``:
  checkpoint every k rounds, an async save error surfaces, a kill
  mid-save never publishes, a structure-free restore.
* Resume is bitwise for the sequential and batched engines (fedavg and
  scaffold, personalization none and pfedpara), and on the training
  CLI (``--ckpt-dir``, ``--resume``).
"""
import json

import jax
import msgpack
import numpy as np
import pytest
import torch

from parity import DEFAULT_ATOL, N_CLIENTS, get_task, make_model
from repro.analysis.program_check import _mini_task, make_mini_server
from repro.checkpoint import CheckpointManager as JaxManager

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, manifest
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs.base import ParamCfg
from repro_torch.fl.client import ClientConfig
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.launch import train
from repro_torch.nn import recurrent as rec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_server(engine="sequential", personalization="none",
                 strategy="fedavg", participation=0.5, **kw):
    """The parity MLP (256-64-10, reference init) on the shared task,
    8 clients, on the CPU."""
    kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
    _, jparams, _ = make_model(kind)
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8))
    return FLServer(lambda p, b: rec.mlp_loss(p, cfg, b),
                    interop.from_jax_params(jax.tree.map(np.asarray,
                                                         jparams)),
                    get_task()["tr"], get_task()["parts"],
                    make_strategy(strategy),
                    ClientConfig(lr=0.1, batch=16, epochs=1),
                    ServerConfig(clients=N_CLIENTS, participation=participation,
                                 rounds=4, engine=engine,
                                 personalization=personalization, **kw),
                    device="cpu",
                    loss_fn_clients=lambda p, b: rec.mlp_loss_clients(p, cfg,
                                                                      b))


def _state_bytes(srv):
    """Every array of a port server's state as bytes, by path."""
    return {p: v.numpy().tobytes()
            for p, v in flatten_with_paths(srv._checkpoint_tree())}


# ------------------------------------------------------ manifest codec

CODEC_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.1, -2.5e300, "", "a" * 31,
    "b" * 32, "é" * 200, "c" * 70000, b"", b"d" * 255, b"e" * 256,
    b"f" * 70000, list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): i for i in range(70000)},
]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=[f"case{i}" for i in range(len(CODEC_CASES))])
def test_manifest_codec_matches_msgpack_bytewise(obj):
    ours = manifest.packb(obj)
    assert ours == msgpack.packb(obj)
    assert msgpack.unpackb(ours, strict_map_key=False) == obj
    assert manifest.unpackb(msgpack.packb(obj)) == obj


def test_manifest_codec_reads_float32_and_rejects_garbage():
    assert manifest.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert manifest.unpackb(msgpack.packb((1, "x"))) == [1, "x"]
    with pytest.raises(ValueError, match="extra data"):
        manifest.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        manifest.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(TypeError, match="ndarray"):
        manifest.packb(np.zeros(2))


def test_manifest_codec_round_trips_a_server_extra(tmp_path):
    srv = _port_server(participation=0.75)
    srv.run(rounds=2)
    mgr = CheckpointManager(str(tmp_path))
    step_dir = srv.save_checkpoint(mgr)
    raw = open(f"{step_dir}/manifest.msgpack", "rb").read()
    doc = msgpack.unpackb(raw)
    assert manifest.packb(doc) == raw == msgpack.packb(doc)
    assert manifest.unpackb(raw) == doc
    extra = doc["extra"]
    st = srv.rng.get_state()
    assert extra["rng"][1] == [int(v) for v in st[1]]
    assert max(extra["rng"][1]) > 2 ** 31       # uint32 words
    assert extra["history"] == srv.history
    assert extra["comm"] == [srv.comm_log.down_bytes, srv.comm_log.up_bytes,
                             2]


# ------------------------------------------------------ on-disk format

def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "a": [np.float32(2.5), np.array([True, False]),
                  rng.integers(-127, 128, (2, 3)).astype(np.int8)],
            "z": np.zeros((0, 3), np.float32)}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    import ml_dtypes

    from repro.checkpoint.manager import _flatten_with_paths

    tree = _mixed_tree()
    bf = torch.randn(4, 6, generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    port_tree = {**tree, "bf": bf, "t": torch.arange(6.0).reshape(2, 3)}
    CheckpointManager(str(tmp_path)).save(7, port_tree, extra={"k": [1, 2]})
    by_path, extra, step = JaxManager(str(tmp_path)).restore_items()
    assert step == 7 and extra == {"k": [1, 2]}
    # the reference's own path order (jax.tree_util's)
    assert list(by_path) == [p for p, _ in _flatten_with_paths(port_tree)]
    assert by_path["bf"].dtype == ml_dtypes.bfloat16
    assert by_path["bf"].tobytes() == bf.view(torch.int16).numpy().tobytes()
    np.testing.assert_array_equal(by_path["t"], np.arange(6.0).reshape(2, 3))
    for p, v in flatten_with_paths(tree):
        assert by_path[p].dtype == np.asarray(v).dtype, p
        assert by_path[p].tobytes() == np.asarray(v).tobytes(), p


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    import jax.numpy as jnp

    tree = {**_mixed_tree(), "bf": jnp.linspace(-3, 3, 12,
                                                dtype=jnp.bfloat16)}
    JaxManager(str(tmp_path)).save(3, tree, extra={"round_idx": 3})
    by_path, extra, step = CheckpointManager(str(tmp_path)).restore_items()
    assert step == 3 and extra == {"round_idx": 3}
    assert by_path["bf"].dtype == torch.bfloat16
    assert by_path["bf"].view(torch.int16).numpy().tobytes() == \
        np.asarray(tree["bf"]).tobytes()
    for p, v in flatten_with_paths(_mixed_tree()):
        got = by_path[p].numpy()
        assert got.dtype == np.asarray(v).dtype and \
            got.tobytes() == np.asarray(v).tobytes(), p


def test_port_server_restores_a_reference_server_checkpoint(tmp_path):
    """A reference batched scaffold run checkpointed after 2 rounds: the
    port's restore_items reads it bit for bit, a port server (same MLP
    and data) restores it and continues round 3 as the reference does."""
    d = str(tmp_path / "ck")
    ref = make_mini_server("batched", "dict", participation=0.75,
                           strategy="scaffold")
    ref.run(rounds=2, ckpt=JaxManager(d))
    want, _, _ = JaxManager(d).restore_items()
    got, extra, step = CheckpointManager(d).restore_items()
    assert step == 2 and sorted(got) == sorted(want)
    for p in want:
        assert got[p].numpy().tobytes() == np.asarray(want[p]).tobytes(), p

    data, parts = _mini_task(0)
    cfg = rec.MLPConfig(in_dim=64, hidden=16, classes=4,
                        param=ParamCfg(kind="fedpara", gamma=0.3,
                                       min_dim_for_factorization=8))
    init = interop.from_jax_params(jax.tree.map(np.asarray,
                                                ref.global_params))
    srv = FLServer(lambda p, b: rec.mlp_loss(p, cfg, b), init, data, parts,
                   make_strategy("scaffold"),
                   ClientConfig(lr=0.1, batch=16, epochs=1),
                   ServerConfig(clients=8, participation=0.75, rounds=3,
                                engine="batched", client_chunk=4),
                   device="cpu",
                   loss_fn_clients=lambda p, b: rec.mlp_loss_clients(p, cfg,
                                                                     b))
    assert srv.restore_checkpoint(CheckpointManager(d)) == 2
    for p, v in flatten_with_paths(srv._checkpoint_tree()):
        assert v.numpy().tobytes() == np.asarray(want[p]).tobytes(), p
    assert srv.history == extra["history"]
    r_ref, r_port = ref.run_round(), srv.run_round()
    assert r_port["arrived_mask"] == r_ref["arrived_mask"]
    assert r_port["sampled"] == r_ref["sampled"]
    assert (srv.comm_log.up_bytes, srv.comm_log.down_bytes) == \
        (ref.comm_log.up_bytes, ref.comm_log.down_bytes)
    for a, b in zip(jax.tree.leaves(ref.global_params),
                    jax.tree.leaves(interop.to_numpy(srv.global_params))):
        assert np.abs(np.asarray(a) - b).max() < DEFAULT_ATOL


def _stale_leaves(tree):
    """{path: numpy leaf} of a ``_stale_ref`` tree, port or reference."""
    from repro.checkpoint.manager import _flatten_with_paths

    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {p: v.numpy() for p, v in flatten_with_paths(tree)}
    return {p: np.asarray(v) for p, v in _flatten_with_paths(tree)}


def test_stale_ref_is_checkpointed_as_the_reference_does(tmp_path):
    """A 2-round sequential MLP run of the reference CLI and of the port
    CLI from the reference's init, each checkpointing every round: both
    checkpoints hold the same sections and paths, ``stale_ref`` (the
    last decoded broadcast) included and within ``DEFAULT_ATOL``; a
    reference server restored from the port's checkpoint has the port's
    ``_stale_ref``, and a port server restored from the reference's has
    the reference's."""
    import contextlib
    import io
    import sys

    from repro.configs.base import ParamCfg as JParamCfg
    from repro.launch import train as jtrain
    from repro.nn import recurrent as jrec

    jcfg = jrec.MLPConfig(in_dim=784, hidden=256, classes=10,
                          param=JParamCfg(kind="fedpara", gamma=0.3,
                                          min_dim_for_factorization=8))
    init = str(tmp_path / "init.npz")
    interop.save_npz(jax.tree.map(np.asarray, jrec.init_mlp_model(
        jax.random.PRNGKey(0), jcfg)), init)
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "2", "--engine",
            "sequential", "--clients", "10", "--local-epochs", "1", "--lr",
            "0.05", "--ckpt-every", "1"]
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    old = sys.argv
    try:
        sys.argv = ["train", *argv, "--ckpt-dir", d_ref]
        with contextlib.redirect_stdout(io.StringIO()):
            jtrain.main()
    finally:
        sys.argv = old
    port = train.main([*argv, "--ckpt-dir", d_port, "--device", "cpu",
                       "--init-params", init])["server"]

    want, _, step_ref = JaxManager(d_ref).restore_items()
    got, _, step_port = CheckpointManager(d_port).restore_items()
    assert step_ref == step_port == 2
    assert sorted(got) == sorted(want)
    stale = sorted(p for p in want if p.startswith("stale_ref/"))
    assert stale and stale == sorted("stale_ref/" + p
                                     for p in _stale_leaves(port._stale_ref))
    for p in stale:
        assert np.abs(got[p].numpy() - np.asarray(want[p])).max() \
            < DEFAULT_ATOL, p

    ref = make_mini_server("sequential", "dict")
    ref.restore_checkpoint(JaxManager(d_port))
    mine = _stale_leaves(port._stale_ref)
    theirs = _stale_leaves(ref._stale_ref)
    assert sorted(theirs) == sorted(mine)
    for p, v in mine.items():
        assert theirs[p].tobytes() == v.tobytes(), p
    back = _port_server()
    back.restore_checkpoint(CheckpointManager(d_ref))
    for p, v in _stale_leaves(back._stale_ref).items():
        assert v.tobytes() == np.asarray(want["stale_ref/" + p]).tobytes(), p


def test_unported_sections_raise_naming_their_item(tmp_path):
    srv = _port_server()
    tree = srv._checkpoint_tree()
    CheckpointManager(str(tmp_path)).save(
        1, {**tree, "arena": {"participation": np.zeros(8, np.int32)}},
        extra={"round_idx": 1, "rng": [], "comm": [0, 0, 0], "history": []})
    with pytest.raises(NotImplementedError, match="A4"):
        srv.restore_checkpoint(CheckpointManager(str(tmp_path)))


# ------------------------------------------------ manager contracts

def test_run_checkpoints_every_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=0)
    _port_server("batched").run(rounds=4, ckpt=mgr, ckpt_every=2)
    assert mgr.all_steps() == [2, 4]
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), keep=1)
    _port_server("batched").run(rounds=3, ckpt=mgr2, ckpt_every=1)
    assert mgr2.all_steps() == [3]


def test_async_save_error_surfaces(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)

    def boom(step, host, extra):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(0, {"x": np.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()   # the error is consumed
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), async_save=True)
    monkeypatch.setattr(mgr2, "_write", boom)
    mgr2.save(0, {"x": np.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr2.save(1, {"x": np.zeros(3)})


def test_async_save_writes_a_copy_taken_at_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = torch.arange(4.0)
    mgr.save(1, {"t": t})
    t.add_(100.0)            # the caller moves on and updates in place
    mgr.wait()
    by_path, _, _ = mgr.restore_items()
    assert torch.equal(by_path["t"], torch.arange(4.0))


def test_kill_mid_save_never_corrupts(tmp_path, monkeypatch):
    import os

    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    tree = {"x": torch.arange(5, dtype=torch.float32)}
    mgr.save(1, tree, extra={"round_idx": 1})
    real_savez = np.savez

    def dying_savez(path, **arrays):
        real_savez(path, **arrays)
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, {"x": torch.full((5,), 9.0)})
    monkeypatch.setattr(np, "savez", real_savez)
    assert mgr.all_steps() == [1]
    assert not os.path.exists(os.path.join(d, "step_0000000002"))
    restored, extra = mgr.restore(None, tree)
    assert torch.equal(restored["x"], tree["x"])
    assert extra["round_idx"] == 1
    mgr.save(2, {"x": torch.full((5,), 9.0)})
    assert mgr.all_steps() == [1, 2]


def test_restore_items_structure_free(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"a": {"b": np.arange(4, dtype=np.int32)}, "c": np.float32(2.5),
            "l": [torch.ones(2), torch.zeros(1)]}
    mgr.save(3, tree, extra={"k": "v"})
    by_path, extra, step = mgr.restore_items()
    assert step == 3 and extra == {"k": "v"}
    assert sorted(by_path) == ["a/b", "c", "l/0", "l/1"]
    np.testing.assert_array_equal(by_path["a/b"].numpy(), tree["a"]["b"])
    assert by_path["c"].item() == 2.5
    from repro_torch.checkpoint import unflatten_paths
    back = unflatten_paths(by_path)
    assert isinstance(back["l"], list) and torch.equal(back["l"][0],
                                                       torch.ones(2))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_items()
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(None, {"a": {"b": np.zeros(3, np.int32)}})


# ------------------------------------------------------ bitwise resume

@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("strategy", ["fedavg", "scaffold"])
@pytest.mark.parametrize("personalization", ["none", "pfedpara"])
def test_resume_is_bitwise(tmp_path, engine, strategy, personalization):
    kw = dict(engine=engine, strategy=strategy,
              personalization=personalization, participation=0.75)
    a = _port_server(**kw)
    hist_a = a.run(rounds=4)
    d = str(tmp_path / "ck")
    b = _port_server(**kw)
    b.run(rounds=2, ckpt=CheckpointManager(d))
    del b
    c = _port_server(**kw)
    assert c.restore_checkpoint(CheckpointManager(d)) == 2
    hist_c = c.run(rounds=4, ckpt=CheckpointManager(d))
    assert json.dumps(hist_a) == json.dumps(hist_c)
    assert _state_bytes(a) == _state_bytes(c)
    assert (a.comm_log.up_bytes, a.comm_log.down_bytes, a.round_idx) == \
        (c.comm_log.up_bytes, c.comm_log.down_bytes, c.round_idx)
    if personalization == "pfedpara":
        assert sorted(c.local_trees) == sorted(a.local_trees)


def test_train_cli_resume_is_bitwise(tmp_path, capsys):
    base = ["--mode", "fl", "--model", "mlp", "--clients", "10",
            "--local-epochs", "1", "--lr", "0.05", "--device", "cpu",
            "--engine", "sequential"]
    whole = train.main(base + ["--rounds", "3"])["record"]
    d = str(tmp_path / "ck")
    train.main(base + ["--rounds", "2", "--ckpt-dir", d, "--ckpt-every",
                       "1"])
    capsys.readouterr()
    resumed = train.main(base + ["--rounds", "3", "--ckpt-dir", d,
                                 "--resume"])
    assert "resumed at round 2" in capsys.readouterr().out
    assert json.dumps(resumed["record"]) == json.dumps(whole)
    assert CheckpointManager(d).all_steps() == [2, 3]
    with pytest.raises(SystemExit, match="--ckpt-dir"):
        train.main(base + ["--rounds", "1", "--resume"])
