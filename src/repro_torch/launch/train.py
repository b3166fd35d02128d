"""Training driver (PyTorch): the paper's FL simulation, ``--mode fl``.

The counterpart of ``repro/launch/train.py --mode fl --model mlp``: the
784-256-10 MLP (``kind``/``gamma`` from ``--param``/``--gamma``,
factorized where that saves parameters) trains on a synthetic 28x28
10-class image set split over ``--clients`` clients by a Dirichlet(0.5)
draw, through ``FLServer``. Each round prints its
record; the run ends with the reference's final JSON record (the last
round's, plus ``comm_up_mb`` / ``comm_down_mb``).

* ``--engine`` picks the round engine as the reference's CLI does, with
  the same default, ``batched``: every sampled client trained in one
  client-stacked program (the client-stacked kernels K2/K3/K4 with
  ``--use-kernels``); ``streaming`` runs it in chunks of
  ``--client-chunk`` clients and folds the uploads with the
  dequant-accumulate kernel (K7); ``sequential`` trains the clients one
  after another. ``async`` is not ported yet (ROADMAP A3) and raises.
* ``--uplink-codec`` / ``--downlink-codec`` take the reference's codec
  specs (``repro_torch.fl.codecs``: delta, topk<f>, lowrank<r>, int8,
  fp16, e.g. ``"delta|topk0.1|int8"``) on every engine; the streaming
  engine folds int8 and fp16 uplinks through K7 at their wire width.
* ``--param`` picks the parameterization: ``fedpara`` (default),
  ``fedpara_tanh``, ``pfedpara``, ``lowrank`` (the conventional X Yᵀ
  baseline at twice the FedPara rank, materialized then multiplied, no
  kernel) or ``original``.

* ``--device`` defaults to ``cuda`` and raises without a card; pass
  ``--device cpu`` to run the plain PyTorch versions on the host.
* ``--use-kernels`` trains through the fused differentiable matmul (K1
  forward, K3/K4 backward; the reference's ``--use-pallas``).
* ``--ckpt-dir D`` checkpoints the server every ``--ckpt-every``
  rounds and at the end (the reference's format, the two latest steps
  kept); ``--resume`` restores the latest step in ``D`` first, prints
  ``resumed at round K`` and runs on to ``--rounds``: the final record
  is the uninterrupted run's, bit for bit.
* ``--init-params <npz>`` starts from a tree written with
  ``repro_torch.interop.save_npz`` (e.g. the reference's
  ``jax.random``-initialized MLP), so a port run can match a reference
  run record for record; without it the port draws its own seeded init.

``main(argv, quant_noise=...)`` passes the server's int8 noise hook
through (``FLServer(quant_noise=...)``, a test hook; not a flag).

Not ported yet: ``--mode pods`` (ROADMAP A8; the default mode, as in the
reference, so an FL run passes ``--mode fl``), the async engine (A3),
rank tiers, faults and defenses (A5).

    python -m repro_torch.launch.train --mode fl --model mlp --rounds 3 \\
        --clients 20 --use-kernels --engine streaming --client-chunk 4
"""
from __future__ import annotations

import argparse
import functools
import json
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ParamCfg
from repro_torch.data import dirichlet_partition, make_image_dataset, train_test_split
from repro_torch.device import resolve_device
from repro_torch.fl.client import ClientConfig
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.interop import load_npz
from repro_torch.nn import recurrent as rec


def mlp_task(seed: int):
    """The reference CLI's MLP task: (train, test) dicts of numpy arrays
    (4000 samples of 28x28x1, 10 classes, noise 0.4), flattened to 784."""
    ds = make_image_dataset(4000, 10, size=28, channels=1, noise=0.4,
                            seed=seed)
    data = {"x": ds["x"].reshape(len(ds["y"]), -1), "y": ds["y"]}
    return train_test_split(data)


def _mlp_loss(cfg, p, b):
    return rec.mlp_loss(p, cfg, b)


def _mlp_loss_clients(cfg, p, b):
    return rec.mlp_loss_clients(p, cfg, b)


def build_fl(args: argparse.Namespace,
             quant_noise: Optional[Callable] = None) -> FLServer:
    """The configured FLServer on ``args.device`` (not yet run);
    ``quant_noise`` is the server's int8 noise hook."""
    if args.model != "mlp":
        raise SystemExit("--mode fl supports --model mlp (the LSTM and VGG "
                         "models are not ported yet)")
    dev = resolve_device(args.device)
    tr, te = mlp_task(args.seed)
    cfg = rec.MLPConfig(in_dim=784, hidden=256, classes=10,
                        param=ParamCfg(kind=args.param, gamma=args.gamma,
                                       min_dim_for_factorization=8,
                                       use_kernels=args.use_kernels))
    if args.init_params:
        params = load_npz(args.init_params, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = rec.init_mlp_model(gen, cfg, dev)
    test = {"x": torch.as_tensor(te["x"][:1000], device=dev),
            "y": torch.as_tensor(te["y"][:1000], device=dev)}

    def eval_fn(p):
        with torch.no_grad():
            return float(rec.mlp_accuracy(p, cfg, test))

    parts = dirichlet_partition(tr["y"], args.clients, 0.5, seed=args.seed)
    return FLServer(functools.partial(_mlp_loss, cfg), params, tr, parts,
                    make_strategy(args.strategy),
                    ClientConfig(lr=args.lr, batch=64,
                                 epochs=args.local_epochs),
                    ServerConfig(clients=args.clients, participation=0.16,
                                 rounds=args.rounds,
                                 personalization=args.personalization,
                                 uplink_codec=args.uplink_codec,
                                 downlink_codec=args.downlink_codec,
                                 engine=args.engine,
                                 client_chunk=args.client_chunk),
                    eval_fn=eval_fn, device=dev,
                    loss_fn_clients=functools.partial(_mlp_loss_clients, cfg),
                    quant_noise=quant_noise)


def final_record(srv: FLServer) -> Dict[str, Any]:
    """The reference CLI's closing record: the last round's, plus the
    run's cumulative wire megabytes per link."""
    out = dict(srv.history[-1])
    out["comm_up_mb"] = srv.comm_log.up_bytes / 1e6
    out["comm_down_mb"] = srv.comm_log.down_bytes / 1e6
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--mode", default="pods", choices=["fl", "pods"])
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--strategy", default="fedavg")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param", default="fedpara")
    ap.add_argument("--gamma", type=float, default=0.3)
    ap.add_argument("--personalization", default="none",
                    choices=["none", "pfedpara", "fedper", "local"])
    ap.add_argument("--uplink-codec", default="",
                    help="uplink codec spec, e.g. 'delta|topk0.1|int8' "
                         "(stages: delta, topk<f>, lowrank<r>, int8, fp16)")
    ap.add_argument("--downlink-codec", default="",
                    help="downlink codec spec (same grammar); applied to "
                         "the payload clients actually train on")
    ap.add_argument("--engine", default="batched",
                    choices=["sequential", "batched", "streaming", "async"],
                    help="FL round engine: the sequential loop, the "
                         "client-batched program, or the streaming chunked "
                         "rounds (async is not ported yet: ROADMAP A3)")
    ap.add_argument("--client-chunk", type=int, default=16,
                    help="streaming engine: clients per chunk; round memory "
                         "peaks at O(client_chunk * model)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="train every FedPara dense() through the fused "
                         "differentiable matmul: K1 forward, K3/K4 backward, "
                         "W never materialized")
    ap.add_argument("--init-params", default="",
                    help="start from this .npz tree (interop.save_npz)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the server into this directory")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="rounds between checkpoints (and one at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir and "
                         "continue to --rounds (bitwise identical to the "
                         "uninterrupted run)")
    return ap


def main(argv: Optional[Sequence[str]] = None, *,
         quant_noise: Optional[Callable] = None) -> Dict[str, Any]:
    """Run the CLI; returns ``{"record", "server", "round_seconds"}``
    (the printed final record, the trained FLServer and each round's
    host wall time, synchronized with the card). ``quant_noise`` is
    handed to ``FLServer`` (its int8 noise hook)."""
    args = parser().parse_args(argv)
    if args.mode == "pods":
        raise SystemExit("--mode pods (the transformer pod trainer, the "
                         "default as in the reference) is not ported yet: "
                         "ROADMAP A8; pass --mode fl")
    srv = build_fl(args, quant_noise)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    if args.resume:
        if ckpt is None:
            raise SystemExit("--resume requires --ckpt-dir")
        if ckpt.latest_step() is not None:
            step = srv.restore_checkpoint(ckpt)
            print(f"resumed at round {step}", flush=True)
    srv.run(args.rounds, log_every=1, ckpt=ckpt,
            ckpt_every=max(1, args.ckpt_every))
    record = final_record(srv)
    print(json.dumps(record, indent=1), flush=True)
    return {"record": record, "server": srv,
            "round_seconds": list(srv.round_seconds)}


if __name__ == "__main__":
    main()
