"""The training CLI under codecs, held against the reference's on the
CPU: ``--uplink-codec`` / ``--downlink-codec`` and ``--param lowrank``
on each engine, 3 rounds of the paper's MLP, against the reference CLI
run in a subprocess without ``XLA_FLAGS`` (as
``tests/test_torch_engines.py`` runs it), from the parameters the
reference initialized, the reference's int8 noise injected through
``train.main(..., quant_noise=...)``. Records are exact but for
``mean_loss`` and ``eval``, which hold 1e-4 for codecs that neither
round nor select and, for the others, 1e-3 relative (loss) and 2e-3
(eval: two of its 1000 test predictions, one argmax flipped at a
near-tie moving it by 1e-3).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ParamCfg as JParamCfg
from repro.nn import recurrent as jrec
from test_torch_codecs import jax_noise

from repro_torch import interop
from repro_torch.launch import train

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ----------------------------------------------------------------- CLI

def _reference_cli_record(argv):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", "repro.launch.train", *argv],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    return json.loads(out[out.rindex("\n{\n") + 1:])


def _init_npz(tmp_path, kind):
    jcfg = jrec.MLPConfig(in_dim=784, hidden=256, classes=10,
                          param=JParamCfg(kind=kind, gamma=0.3,
                                          min_dim_for_factorization=8))
    path = str(tmp_path / "init.npz")
    interop.save_npz(jax.tree.map(np.asarray, jrec.init_mlp_model(
        jax.random.PRNGKey(0), jcfg)), path)
    return path


@pytest.mark.parametrize("engine,up,down,param,rounding", [
    (["--engine", "batched"], "delta|topk0.1|int8", "fp16", "fedpara",
     True),
    (["--engine", "streaming", "--client-chunk", "3"], "fp16", "delta|int8",
     "fedpara", True),
    (["--engine", "sequential"], "delta|lowrank0.25", "delta", "fedpara",
     False),
    (["--engine", "batched"], "", "", "lowrank", False),
], ids=["batched-topk-int8", "streaming-fp16", "sequential-lowrank-codec",
        "batched-param-lowrank"])
def test_train_cli_codecs_match_reference_record(tmp_path, engine, up, down,
                                                 param, rounding):
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "3", "--lr",
            "0.05", "--param", param, "--uplink-codec", up,
            "--downlink-codec", down, *engine]
    want = _reference_cli_record(argv)
    got = train.main(argv + ["--device", "cpu", "--use-kernels",
                             "--init-params", _init_npz(tmp_path, param)],
                     quant_noise=jax_noise)["record"]
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        if k == "mean_loss":
            tol = 1e-3 * abs(want[k]) if rounding else 1e-4
            assert abs(got[k] - want[k]) <= tol, k
        elif k == "eval":
            assert abs(got[k] - want[k]) <= (2e-3 if rounding else 1e-4), k
        else:
            assert got[k] == want[k], k
