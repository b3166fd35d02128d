"""Codec state across checkpoints, held against the reference on the
CPU.

* A port run with an error-feedback codec on both links (uplink
  ``delta|topk0.1|int8``, downlink ``delta|int8`` or
  ``delta|topk0.5|int8``) interrupted after 2 rounds and resumed runs on
  bit for bit, on each engine: the downlink's ``down_ref`` / ``down_ef``
  and every client's ``_ef_up`` are checkpointed.
* A reference checkpoint holding those sections restores in the port
  bit for bit, and the next round meets the whole-run oracle of
  ``tests/test_torch_codec_engines.py`` (masks and bytes exact, each
  leaf within 1e-3 relative); a port checkpoint restores in the
  reference bit for bit.
"""
import json

import jax
import numpy as np
import pytest
import torch

from parity import N_CLIENTS, get_task, make_model
from repro.checkpoint import CheckpointManager as JaxManager
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.fl import client as jclient
from repro.fl import make_strategy as jmake_strategy
from test_torch_codecs import jax_noise

from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs.base import ParamCfg
from repro_torch.fl import client
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.nn import recurrent as rec

UP, DOWN = "delta|topk0.1|int8", "delta|int8"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_server(engine, up=UP, down=DOWN, personalization="none"):
    kind = "pfedpara" if personalization == "pfedpara" else "fedpara"
    _, jparams, _ = make_model(kind)
    cfg = rec.MLPConfig(in_dim=256, hidden=64, classes=10,
                        param=ParamCfg(kind=kind, gamma=0.3,
                                       min_dim_for_factorization=8,
                                       use_kernels=True))
    return FLServer(lambda p, b: rec.mlp_loss(p, cfg, b),
                    interop.from_jax_params(jax.tree.map(np.asarray,
                                                         jparams)),
                    get_task()["tr"], get_task()["parts"],
                    make_strategy("fedavg"),
                    client.ClientConfig(lr=0.1, batch=16, epochs=1),
                    ServerConfig(clients=N_CLIENTS, participation=0.5,
                                 rounds=4, engine=engine,
                                 personalization=personalization,
                                 uplink_codec=up, downlink_codec=down,
                                 client_chunk=3),
                    device="cpu",
                    loss_fn_clients=lambda p, b: rec.mlp_loss_clients(p, cfg,
                                                                      b),
                    quant_noise=jax_noise)


def _state_bytes(srv):
    return {p: v.numpy().tobytes()
            for p, v in flatten_with_paths(srv._checkpoint_tree())}


# ------------------------------------------------------ bitwise resume

@pytest.mark.parametrize("engine,personalization,down", [
    ("sequential", "none", DOWN),
    ("batched", "none", "delta|topk0.5|int8"),
    ("batched", "pfedpara", DOWN),
    ("streaming", "none", DOWN),
])
def test_resume_with_ef_codecs_is_bitwise(tmp_path, engine, personalization,
                                          down):
    kw = dict(engine=engine, personalization=personalization, down=down)
    a = _port_server(**kw)
    hist_a = a.run(rounds=4)
    d = str(tmp_path / "ck")
    b = _port_server(**kw)
    b.run(rounds=2, ckpt=CheckpointManager(d))
    sections = {p.split("/")[0] for p in _state_bytes(b)}
    assert {"down_ref", "client_states"} <= sections
    assert ("down_ef" in sections) == ("topk" in down)
    assert any("/_ef_up/" in p for p in _state_bytes(b))
    del b
    c = _port_server(**kw)
    assert c.restore_checkpoint(CheckpointManager(d)) == 2
    hist_c = c.run(rounds=4, ckpt=CheckpointManager(d))
    assert json.dumps(hist_a) == json.dumps(hist_c)
    assert _state_bytes(a) == _state_bytes(c)


# ----------------------------------- checkpoints across the two packages

def _ref_server(engine, down):
    jcfg, params, loss_fn = make_model("fedpara")
    return JFLServer(loss_fn, params, get_task()["tr"], get_task()["parts"],
                     jmake_strategy("fedavg"),
                     jclient.ClientConfig(lr=0.1, batch=16, epochs=1),
                     JServerConfig(clients=N_CLIENTS, participation=0.5,
                                   rounds=4, engine=engine, uplink_codec=UP,
                                   downlink_codec=down, client_chunk=3))


@pytest.mark.parametrize("engine", ["batched", "streaming"])
def test_reference_codec_checkpoint_restores_in_the_port(tmp_path, engine):
    """The reference checkpoints ``down_ref``, ``down_ef`` and every
    client's ``_ef_up`` after 2 rounds; the port restores them bit for
    bit and its next round meets the rounding oracle."""
    down = "delta|topk0.5|int8"
    d = str(tmp_path / "ck")
    ref = _ref_server(engine, down)
    ref.run(rounds=2, ckpt=JaxManager(d))
    want, _, _ = JaxManager(d).restore_items()
    assert {p.split("/")[0] for p in want} >= {"down_ref", "down_ef",
                                               "client_states"}
    assert any("/_ef_up/" in p for p in want)
    srv = _port_server(engine, down=down)
    assert srv.restore_checkpoint(CheckpointManager(d)) == 2
    got = dict(flatten_with_paths(srv._checkpoint_tree()))
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].numpy().tobytes() == np.asarray(want[p]).tobytes(), p
    r_ref, r_port = ref.run_round(), srv.run_round()
    for k in ("arrived_mask", "sampled", "down_bytes", "up_bytes"):
        assert r_port[k] == r_ref[k], k
    assert abs(r_port["mean_loss"] - r_ref["mean_loss"]) <= \
        1e-3 * abs(r_ref["mean_loss"])
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                 ref.global_params)),
                    jax.tree.leaves(interop.to_numpy(srv.global_params))):
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a)


def test_port_codec_checkpoint_restores_in_the_reference(tmp_path):
    down = "delta|topk0.5|int8"
    d = str(tmp_path / "ck")
    srv = _port_server("batched", down=down)
    srv.run(rounds=2, ckpt=CheckpointManager(d))
    mine = dict(flatten_with_paths(srv._checkpoint_tree()))
    ref = _ref_server("batched", down)
    assert ref.restore_checkpoint(JaxManager(d)) == 2
    theirs = dict(flatten_with_paths(interop.from_jax_params(
        jax.tree.map(np.asarray, ref._checkpoint_tree()))))
    assert sorted(theirs) == sorted(mine)
    for p, v in mine.items():
        assert theirs[p].numpy().tobytes() == v.numpy().tobytes(), p
    ref.run_round()   # the reference runs on from the port's state
