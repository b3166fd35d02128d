"""Serving driver (PyTorch): FL checkpoint -> planned engine -> timed
generation.

Loads a trained federation from a checkpoint directory (``--ckpt``, the
port's or the reference's format) and serves it through
:class:`repro_torch.serve.ServeEngine`. With neither ``--ckpt`` nor
``--params`` it first trains a tiny pFedPara (or FedPara) federation and
checkpoints it (:func:`tiny_fl_checkpoint`), so the whole
checkpoint -> serve handoff always runs, as the reference's driver does.
``--params <npz>`` serves a bare tree written with
``repro_torch.interop.save_npz`` instead (e.g. the reference's
JAX-initialized params carried across).

* ``--mode {precompose,fused,auto}`` — per-layer weight layout (the
  precomposed caches are built by the compose kernels K5/K6).
* ``--cache-dtype {int8,fp16}`` — precomposed-cache precision.
* ``--kind`` — the factorization the checkpoint was trained with
  (default: pfedpara with ``--users``, else fedpara).
* ``--users N`` — pFedPara: serve a rotating cohort over the resident
  users (with ``--params``: N seeded users).
* ``--rounds`` — training rounds of the self-made checkpoint.
* ``--smoke`` — the CI gate: a 1-round tiny checkpoint served in both
  modes (fp16 cache and fused) for 8 decode steps over 2 alternating
  user cohorts, precompose vs fused logits within 2e-2 relative. The
  reference's gate also counts JAX recompiles; PyTorch runs eagerly and
  has no compile to count, so that check has no counterpart here.
* ``--layers N`` cuts depth and ``--reduced`` uses the config's
  smoke-test size (``--params`` only: a checkpoint's config is the tiny
  federation's, reduced qwen3 with 2 layers).

Timing: one untimed warmup (prefill + one decode step), then prefill
and decode are timed separately — with CUDA events on the card, with
the host clock on ``--device cpu`` (the report names its device).

    python -m repro_torch.launch.serve --ckpt CKPT_DIR --users 2 \\
        --mode precompose --cache-dtype int8 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.data import iid_partition, make_token_lm_dataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import comm
from repro_torch.fl.client import ClientConfig
from repro_torch.fl.server import FLServer, ServerConfig
from repro_torch.fl.strategies import make_strategy
from repro_torch.interop import load_npz
from repro_torch.nn.transformer import ModelOptions, build_model
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_map

# the tiny federation's model options (the reference's, fp32)
TINY_OPTS = ModelOptions(attn_chunk=8, logit_chunk=16, dtype=torch.float32)


def serve_config(arch: str, kind: str, *, layers: int = 0,
                 reduced: bool = False) -> ArchConfig:
    """The arch's config with the factorization ``kind`` and optional
    depth / size cuts."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, min_dim_for_factorization=8, gamma=0.5))
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(cfg.param,
                                                             kind=kind))
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def tiny_config(arch: str, kind: str) -> ArchConfig:
    """The tiny federation's config: ``arch`` reduced to its smoke-test
    size, 2 layers, ``kind``, gamma 0.5, factorized from 8 wide."""
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, n_layers=2, param=dataclasses.replace(
        cfg.param, kind=kind, min_dim_for_factorization=8, gamma=0.5))


def build_federation(cfg: ArchConfig, opts: ModelOptions, *, rounds: int,
                     clients: int, seed: int = 0, device: DeviceLike = None,
                     params: Optional[Dict[str, Any]] = None) -> FLServer:
    """The language-model federation the reference's
    ``tiny_fl_checkpoint`` trains, for any decoder config: ``clients``
    clients of 12 token sequences of 16 (``make_token_lm_dataset``, iid
    split), all taking part every round, FedAvg, SGD at lr 0.05 in
    batches of 8 for one local epoch, pFedPara personalization when
    ``cfg``'s kind is pfedpara, the sequential engine. ``params`` is the
    initial tree (e.g. the reference's init carried across), else the
    port's seeded init. Returns the server, not yet run."""
    dev = resolve_device(device)
    model = build_model(cfg, opts)
    if params is None:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), dev)
    toks = make_token_lm_dataset(12 * clients, 16, cfg.vocab_size, seed=seed)
    parts = iid_partition(len(toks), clients)
    personalization = "pfedpara" if cfg.param.kind == "pfedpara" else "none"
    srv = FLServer(model.loss, params, {"tokens": toks}, parts,
                   make_strategy("fedavg"),
                   ClientConfig(lr=0.05, batch=8, epochs=1),
                   ServerConfig(clients=clients, participation=1.0,
                                rounds=rounds,
                                personalization=personalization),
                   device=dev)
    return srv


def tiny_fl_checkpoint(workdir: str, *, arch: str = "qwen3-8b",
                       rounds: int = 2, clients: int = 4,
                       kind: str = "pfedpara", seed: int = 0,
                       device: DeviceLike = None,
                       params: Optional[Dict[str, Any]] = None):
    """Train a miniature federation (:func:`tiny_config`,
    :func:`build_federation`, ``rounds`` rounds) and checkpoint it into
    ``workdir``;
    returns ``(ckpt_dir, cfg, opts)`` ready for
    ``ServeEngine.from_checkpoint``. The demo and CI path: real
    deployments pass ``--ckpt`` from a full training run."""
    cfg = tiny_config(arch, kind)
    srv = build_federation(cfg, TINY_OPTS, rounds=rounds, clients=clients,
                           seed=seed, device=device, params=params)
    srv.run()
    srv.save_checkpoint(CheckpointManager(workdir))
    return workdir, cfg, TINY_OPTS


def seeded_params(cfg: ArchConfig, seed: int, device) -> Dict[str, Any]:
    """The port's seeded random parameters for ``cfg`` on ``device``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return build_model(cfg).init_params(gen, device)


def seeded_users(params: Dict[str, Any], n_users: int, seed: int
                 ) -> Dict[int, Any]:
    """``n_users`` personal (x2, y2) halves: the params' own local half
    plus seeded noise of 10% of each leaf's std, one draw per user."""
    local = comm.split_pfedpara(params)[1]
    out = {}
    for u in range(n_users):
        def jitter(a, u=u):
            gen = torch.Generator(device=a.device).manual_seed(seed + 7919 * u)
            noise = torch.randn(a.shape, generator=gen, device=a.device)
            return a + 0.1 * a.std() * noise
        out[u] = tree_map(jitter, local)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Timer:
    """CUDA-event timer on the card, host clock elsewhere (ms)."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def __enter__(self):
        if self.dev.type == "cuda":
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.b.record()
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def serve_timed(eng: ServeEngine, prompts: torch.Tensor, gen_len: int,
                user_ids: Optional[Sequence] = None) -> Dict[str, Any]:
    """Warmed-up prefill + greedy decode, timed separately; returns the
    report (times in ms, generated tokens, device)."""
    dev = eng.device
    tokens = torch.as_tensor(prompts, device=dev)
    B, S = tokens.shape

    wcache = eng.init_cache(B, S + gen_len)
    wcache, wlogits = eng.prefill(tokens, wcache, user_ids)
    wtok = torch.argmax(wlogits, -1)[:, None]
    eng.decode_step(wcache, wtok, S, user_ids)
    _sync(dev)
    del wcache

    cache = eng.init_cache(B, S + gen_len)
    with _Timer(dev) as tp:
        cache, logits = eng.prefill(tokens, cache, user_ids)
    out = []
    tok = torch.argmax(logits, -1)[:, None]
    with _Timer(dev) as td:
        for i in range(gen_len):
            out.append(tok[:, 0])
            logits, cache = eng.decode_step(cache, tok, S + i, user_ids)
            tok = torch.argmax(logits, -1)[:, None]
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "clock": "cuda_events" if dev.type == "cuda" else "host",
        "batch": B, "prompt_len": S, "gen_len": gen_len,
        "prefill_ms": tp.ms,
        "prefill_tok_s": B * S / max(tp.ms, 1e-9) * 1e3,
        "decode_ms": td.ms,
        "decode_tok_s": B * gen_len / max(td.ms, 1e-9) * 1e3,
        "tokens": torch.stack(out, 1).cpu(),
        "last_logits": logits,
    }


def run_smoke(seed: int = 0, device: DeviceLike = None) -> float:
    """The CI gate: a 1-round, 2-client tiny checkpoint served under both
    modes (precompose with the fp16 cache, and fused), 8 decode steps
    after the prompt with the 2 users' cohort alternating; returns the
    precompose-vs-fused relative error of the last logits, which must
    stay below 2e-2."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        ckpt, cfg, opts = tiny_fl_checkpoint(d, rounds=1, clients=2,
                                             seed=seed, device=dev)
        uids = [0, 1]
        tokens = torch.as_tensor(make_token_lm_dataset(2, 8, cfg.vocab_size,
                                                       seed=1), device=dev)
        last = {}
        for mode in ("precompose", "fused"):
            eng = ServeEngine.from_checkpoint(
                ckpt, cfg, mode=mode, cache_dtype="fp16", batch=2,
                opts=opts, device=dev)
            cache = eng.init_cache(2, 8 + 8)
            cache, logits = eng.prefill(tokens, cache, user_ids=uids)
            tok = torch.argmax(logits, -1)[:, None]
            for i in range(8):
                cohort = uids if i % 2 == 0 else uids[::-1]
                logits, cache = eng.decode_step(cache, tok, 8 + i,
                                                user_ids=cohort)
                tok = torch.argmax(logits, -1)[:, None]
            last[mode] = logits.float().cpu()
            print(f"smoke {mode}: 8 decode steps, 2 cohorts", flush=True)
    a, b = last["precompose"], last["fused"]
    rel = float((a - b).abs().max() / (b.abs().max() + 1e-9))
    if not rel < 2e-2:
        raise AssertionError(f"mode parity: rel err {rel:.3e}")
    print(f"smoke parity: precompose-vs-fused rel err {rel:.2e} OK",
          flush=True)
    return rel


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of an FL run; with neither "
                         "it nor --params a tiny federation is trained "
                         "first")
    ap.add_argument("--params", default=None,
                    help=".npz params tree (interop.save_npz) to serve "
                         "instead of a checkpoint")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--kind", default=None,
                    choices=["fedpara", "fedpara_tanh", "pfedpara"],
                    help="factorization of the weights (default: pfedpara "
                         "with --users, else fedpara)")
    ap.add_argument("--mode", default="auto",
                    choices=["precompose", "fused", "auto"])
    ap.add_argument("--cache-dtype", default="int8", choices=["int8", "fp16"])
    ap.add_argument("--users", type=int, default=0,
                    help="pFedPara cohort over the resident users (0 = "
                         "global model only)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2,
                    help="training rounds of the self-made checkpoint")
    ap.add_argument("--layers", type=int, default=0,
                    help="--params: cut depth to this many layers (0 = "
                         "config's)")
    ap.add_argument("--reduced", action="store_true",
                    help="--params: the config's smoke-test size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: both modes from a tiny checkpoint, "
                         "precompose-vs-fused parity")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.smoke:
        return {"smoke_rel_err": run_smoke(args.seed, dev)}
    kind = args.kind or ("pfedpara" if args.users else "fedpara")
    engine_kw = dict(mode=args.mode, cache_dtype=args.cache_dtype,
                     batch=args.batch, device=dev)
    t0 = time.perf_counter()
    if args.params:
        cfg = serve_config(args.arch, kind, layers=args.layers,
                           reduced=args.reduced)
        params = load_npz(args.params, dev)
        local = (seeded_users(params, args.users, args.seed) if args.users
                 else None)
        eng = ServeEngine(cfg, params, local, **engine_kw)
        del params, local
    else:
        tmp = None
        ckpt, cfg, opts = args.ckpt, tiny_config(args.arch, kind), TINY_OPTS
        if ckpt is None:
            tmp = tempfile.TemporaryDirectory()
            ckpt, cfg, opts = tiny_fl_checkpoint(
                tmp.name, arch=args.arch, rounds=args.rounds,
                clients=max(2, args.users), kind=kind, seed=args.seed,
                device=dev)
            print(f"trained + checkpointed tiny federation ({args.rounds} "
                  f"rounds): {time.perf_counter() - t0:.1f}s", flush=True)
            t0 = time.perf_counter()
        eng = ServeEngine.from_checkpoint(ckpt, cfg, opts=opts, **engine_kw)
        if tmp is not None:
            tmp.cleanup()
    _sync(dev)
    build_s = time.perf_counter() - t0
    rows = eng.decision_table()
    modes: Dict[str, int] = {}
    for r in rows:
        modes[r["mode"]] = modes.get(r["mode"], 0) + 1

    uids = ([eng.arena.uids[i % eng.arena.n_users] for i in range(args.batch)]
            if eng.arena is not None else None)
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)))
    rep = serve_timed(eng, prompts, args.gen_len, uids)
    summary = {k: v for k, v in rep.items()
               if k not in ("tokens", "last_logits")}
    summary.update({"arch": cfg.name, "layers": cfg.n_layers, "kind": kind,
                    "mode": args.mode, "cache_dtype": args.cache_dtype,
                    "users": args.users, "plan": modes,
                    "build_s": build_s, "state_bytes": eng.state_bytes(),
                    "arena_bytes": eng.arena_bytes(),
                    "sample_tokens": rep["tokens"][0, :12].tolist()})
    print(json.dumps(summary, default=str))
    return rep


if __name__ == "__main__":
    main()
