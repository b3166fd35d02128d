"""Serving driver (PyTorch): params -> planned engine -> timed generation.

Weights come from ``--params <npz>`` (a tree written with
``repro_torch.interop.save_npz``, e.g. the reference's JAX-initialized
params carried across) or else from the port's own seeded init.

* ``--mode {precompose,fused,auto}`` — per-layer weight layout.
* ``--cache-dtype {int8,fp16}`` — precomposed-cache precision.
* ``--users N`` — pFedPara: serve N resident users, one per batch row.
* ``--layers N`` cuts depth (0 keeps the config's); ``--reduced`` uses
  the config's smoke-test size.

Timing: one untimed warmup (prefill + one decode step), then prefill
and decode are timed separately — with CUDA events on the card, with
the host clock on ``--device cpu`` (the report names its device).

    python -m repro_torch.launch.serve --arch qwen3-8b --mode precompose \\
        --cache-dtype int8 --batch 4 --prompt-len 128 --gen-len 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.fl import comm
from repro_torch.interop import load_npz
from repro_torch.nn.transformer import build_model
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_map


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


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--params", default=None,
                    help=".npz params tree (interop.save_npz); omitted -> "
                         "the port's seeded init")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--kind", default=None,
                    choices=["fedpara", "fedpara_tanh", "pfedpara"])
    ap.add_argument("--mode", default="auto",
                    choices=["precompose", "fused", "auto"])
    ap.add_argument("--cache-dtype", default="int8", choices=["int8", "fp16"])
    ap.add_argument("--users", type=int, default=0,
                    help="pFedPara resident users (0 = global model only)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (0 = config's)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    kind = args.kind or ("pfedpara" if args.users else "fedpara")
    cfg = serve_config(args.arch, kind, layers=args.layers,
                       reduced=args.reduced)
    if args.params:
        params = load_npz(args.params, dev)
    else:
        params = seeded_params(cfg, args.seed, dev)
    local = seeded_users(params, args.users, args.seed) if args.users else None
    batch = args.users or args.batch
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, local, mode=args.mode,
                      cache_dtype=args.cache_dtype, batch=batch, device=dev)
    del params, local
    _sync(dev)
    build_s = time.perf_counter() - t0
    rows = eng.decision_table()
    modes: Dict[str, int] = {}
    for r in rows:
        modes[r["mode"]] = modes.get(r["mode"], 0) + 1

    uids = eng.arena.uids[:batch] if eng.arena is not None else None
    prompts = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, size=(batch, args.prompt_len)))
    rep = serve_timed(eng, prompts, args.gen_len, uids)
    summary = {k: v for k, v in rep.items()
               if k not in ("tokens", "last_logits")}
    summary.update({"arch": cfg.name, "layers": cfg.n_layers, "kind": kind,
                    "mode": args.mode, "cache_dtype": args.cache_dtype,
                    "users": args.users, "plan": modes,
                    "build_s": build_s, "state_bytes": eng.state_bytes(),
                    "arena_bytes": eng.arena_bytes(),
                    "sample_tokens": rep["tokens"][0, :12].tolist()})
    print(json.dumps(summary))
    return rep


if __name__ == "__main__":
    main()
