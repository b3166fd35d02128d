"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Drives the port's paths (``repro_torch``) on the card through its
hand-written CUDA kernels: serving at qwen3-8b's full width, FL
training of the paper's MLP at its full width through the sequential,
batched and streaming engines, and the checkpoint -> serve path of a
full-width pFedPara federation; holds every kernel against its plain
PyTorch version. Phases, each printed on its own line; any failed check
raises, so the script exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once); print the build time, the
   registers and spills ``-Xptxas -v`` reports for the fused, serve and
   factor-gradient kernels, the serve kernels' and K4's dynamic shared
   memory, and the card's name and power limit;
2. every kernel against its plain version at every full-width qwen3-8b
   shape, bf16 at 4 rows (decode) and 512 rows (prefill; the backward
   kernels K3 and K4 at 512 rows only); the fp32 builds that the other
   phases run (K1, K3, K4, K8 with int8 and fp16 caches) at the same
   shapes; ragged fp32 shapes and the FL MLP's two shapes; median time
   of the bf16 cases (CUDA events, L2 flushed before each run), the
   bound at that shape, the plain version's time and one PyTorch library
   call's time where one call computes the function (``torch.matmul``
   on the dequantized / composed W, a yardstick the port never calls);
   the client-stacked kernels of the batched engine (K2, K3 and K4 with
   a client axis) at the same shapes for 4 clients of 128 rows (bf16,
   and fp32), at ragged shapes and at the MLP's shapes for 8 clients of
   64 rows; the dequant-accumulate K7 for 16 clients over one qwen3-8b
   layer's factors (int8, fp16 and fp32 wire; ``torch.addmv`` on the
   widened stack as the yardstick), a ragged length, an unaligned leaf,
   zero coefficients and the MLP's streaming leaves; K8's prefill
   kernel at 33, 100 and 517 rows with ragged m and n (int8 and fp16
   caches, bf16 and fp32 activations), K8's decode kernel at 1, 4, 17
   and 32 rows with n = 1000 and m = 4096 or 1001 (both caches, both
   activation types), K4 at batches of 1, 33 and 100 rows, ragged own
   and other axes, ranks 1, 7 and 300 and 1, 3 and 8 clients (bf16 and
   fp32, all kinds), two launches of K4 (2-D and with clients) and of
   K8's split decode giving the same bits, and K10 at 1, 17 and 129 rows
   per user with strided user slabs (fp32 activations); the compose
   kernels K5 (W of one projection, fp32, fp16 and bf16, all kinds) and
   K6 (the projection stacked over 2, 4 and, to fp16 W, 36 layers, the
   depths of phases 10 and 4) at the same shapes, and at the reference
   tests' ragged shapes;
3. 36-layer qwen3-8b, ``kind=fedpara``, precompose int8: the cache
   composed by K5 (at least 7 x 36 launches, build seconds reported),
   batch 4, prompt 128, 16 greedy tokens through K8;
4. the same weights in fused mode (K1 on prefill, the Gram identity on
   decode) against precompose fp16 (the cache composed by K6, at least
   7 stacked launches; K8), fp32 activations;
5. pFedPara, 4 resident users, precompose int8, 4 layers: K10 (bf16)
   against each user's merge-then-plain logits (fp32); prefill and 4
   decode steps timed with CUDA events;
6. 2 layers: the engine on the card against the same engine on the
   host (plain versions), same weights;
7. one full-width qwen3-8b layer's 7 projections, 512 rows, forward and
   backward through ``FedParaMatmul`` (K1, K3, K4) against plain
   autograd (materialize W, then matmul), fp32, with K4's share of the
   step's device time;
8. the FL training path: ``launch/train.py --mode fl --model mlp
   --rounds 3 --clients 20 --use-kernels --engine sequential`` on the
   card against the same run on the host, from the same initial weights;
9. the FL engines: ``launch/train.py --mode fl --model mlp --rounds 3
   --clients 50 --use-kernels`` with ``--engine batched`` on the card
   and on the host, and with ``--engine streaming --client-chunk 3`` on
   the card (8 clients a round: 3 chunks, one pad slot);
10. the checkpoint -> serve path (:func:`phase_checkpoint_serve`):
    qwen3-8b at its published widths, 2 layers, pFedPara, one FL round
    on the card (K1, K3, K4) against the same round with the kernels
    off (loss and parameters 1e-4), checkpointed (bytes, save and
    restore seconds printed) and restored bitwise, then served from the
    checkpoint: the global model through its int8 (K5) and fp16 (K6)
    caches against fused, the 2 users through K10 and fused against
    merge-then-plain;
11. the ``{"kernels": [...]}`` line (K8 twice: its decode and its
    prefill shape), then the closing ``{"ok": true}``.

Run from the repository root: ``python3 chip_smoke.py`` (one card).
``--quick`` builds and checks the kernels at two shapes and stops;
``--out FILE`` also writes every measurement to FILE as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SHAPES = {"wq": (4096, 4096, 160), "wk": (4096, 1024, 70),
          "wv": (4096, 1024, 70), "wo": (4096, 4096, 160),
          "w_gate": (4096, 12288, 211), "w_up": (4096, 12288, 211),
          "w_down": (12288, 4096, 211)}
DISTINCT = {"wq": SHAPES["wq"], "wk": SHAPES["wk"],
            "w_gate": SHAPES["w_gate"], "w_down": SHAPES["w_down"]}
# the FL MLP's factorized layers (784 -> 256 -> 10, gamma 0.3) at batch 64
MLP_SHAPES = {"fc1": (64, 784, 256, 40), "fc2": (64, 256, 10, 4)}
CLIENTS, CLIENT_ROWS = 4, 128      # client-stacked kernels at full width
AGG_CLIENTS = 16                   # K7: the default client_chunk
AGG_L = sum(2 * r * (m + n) for m, n, r in SHAPES.values())  # 27,418,624
REPLACES = {
    "fedpara_matmul": "src/repro/kernels/fedpara_matmul.py:45 _kernel",
    "fedpara_dx": "src/repro/kernels/fedpara_grad.py:80 _dx_body",
    "fedpara_dfactors": "src/repro/kernels/fedpara_grad.py:191 "
                        "_dfactors_body",
    "w8_matmul": "src/repro/kernels/serve_matmul.py:48 _w8_kernel",
    "cache_residual_matmul": "src/repro/kernels/serve_matmul.py:68 "
                             "_resid_kernel + :92 _resid_kernel_users",
    "fedpara_matmul_clients": "src/repro/kernels/fedpara_matmul.py:76 "
                              "_kernel_batched",
    "fedpara_dx_clients": "src/repro/kernels/fedpara_grad.py:80 _dx_body "
                          "(lead=True)",
    "fedpara_dfactors_clients": "src/repro/kernels/fedpara_grad.py:191 "
                                "_dfactors_body (lead=True)",
    "dequant_acc": "src/repro/kernels/agg.py:63 _agg_body",
    "fedpara_compose": "src/repro/kernels/fedpara_compose.py:26 _kernel",
    "fedpara_compose_stacked": "src/repro/kernels/fedpara_compose.py:101 "
                               "_kernel_batched",
}
SOURCES = {"fedpara_matmul": "src/repro_torch/csrc/fedpara_matmul.cu",
           "fedpara_dx": "src/repro_torch/csrc/fedpara_matmul.cu",
           "fedpara_dfactors": "src/repro_torch/csrc/fedpara_grad.cu",
           "w8_matmul": "src/repro_torch/csrc/serve_matmul.cu",
           "cache_residual_matmul": "src/repro_torch/csrc/serve_matmul.cu",
           "fedpara_matmul_clients": "src/repro_torch/csrc/fedpara_matmul.cu",
           "fedpara_dx_clients": "src/repro_torch/csrc/fedpara_matmul.cu",
           "fedpara_dfactors_clients": "src/repro_torch/csrc/fedpara_grad.cu",
           "dequant_acc": "src/repro_torch/csrc/agg.cu",
           "fedpara_compose": "src/repro_torch/csrc/fedpara_compose.cu",
           "fedpara_compose_stacked":
               "src/repro_torch/csrc/fedpara_compose.cu"}
# an fp32-accurate product on the tensor cores takes three TF32 passes
# (3xTF32: hi·hi + hi·lo + lo·hi, csrc/mma.cuh)
TF32_PASSES = 3
STACK_LAYERS = (2, 4)              # K6: layer-stacked nodes (2 timed)
MAIN_STACK = 36                    # K6 at phase 4's depth (fp16, timed)


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    check(float(w.abs().max()) > 0, "all-zero reference: the check is void")
    return float((g - w).abs().max() / (w.abs().max() + 1e-12))


class Clock:
    """Median device time of a callable: CUDA events around each run,
    the 50 MB L2 flushed before each (the main path finds its weights
    cold: a layer's caches are read once per pass). A short spin on the
    card (``HEAD_CYCLES``) sits between the flush and the first event, so
    that the host has queued the callable's launches before the card
    reaches them: the time is the card's, not the host's enqueue."""

    HEAD_CYCLES = 2_000_000      # about 1 ms at the H100's clock

    def __init__(self, reps: int):
        self.reps = reps
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, reps: int = 0) -> float:
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps or self.reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.HEAD_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes: float, flops_bf16: float = 0.0, f32: float = 0.0,
             elem: float = 0.0) -> tuple:
    """(ms, bound_by): the larger of bytes over the HBM rate and the
    operations over the peak rate of their type (the H100 data-sheet
    constants the port's cost model uses): bf16 products at the bf16
    tensor-core rate; fp32 matrix products (``f32``: rank-r composes,
    the Gram route, fp32 contractions) at the 3xTF32 rate, the cheapest
    way to them at fp32 accuracy; elementwise fp32 work (``elem``) at
    the CUDA cores' fp32 rate."""
    from repro_torch.serve.cost_model import (H100_BF16_TFLOPS,
                                              H100_FP32_TFLOPS, H100_HBM_GBPS,
                                              H100_TF32_TFLOPS)

    t_bytes = nbytes / (H100_HBM_GBPS * 1e9)
    t_ops = (flops_bf16 / (H100_BF16_TFLOPS * 1e12)
             + f32 / (H100_TF32_TFLOPS / TF32_PASSES * 1e12)
             + elem / (H100_FP32_TFLOPS * 1e12))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compose_ops(m: int, n: int, r: int) -> float:
    """The fp32 operations of composing W = f1(X1Y1ᵀ) ⊙ f2(X2Y2ᵀ): two
    rank-r products, 4mnr (the Hadamard product and the variant, a few
    per weight, are left out)."""
    return 4.0 * m * n * r


def fedpara_ops(rows: int, m: int, n: int, r: int, kind: str,
                x_bits: int = 16) -> dict:
    """The operations y = x·W needs, W = f1(X1Y1ᵀ) ⊙ f2(X2Y2ᵀ): the
    cheaper of composing W tile by tile (4mnr fp32, then the 2·rows·mn
    contraction in x's type) and, where no tanh stands between the
    factors, the Hadamard-Gram identity (2·rows·r²(m+n) fp32, plus
    2·rows·r(m+n) for pFedPara's "+1"), priced at the card's rates."""
    mm = 2.0 * rows * m * n
    compose = ({"f16": mm, "f32": compose_ops(m, n, r)} if x_bits == 16
               else {"f16": 0.0, "f32": compose_ops(m, n, r) + mm})
    if kind == "fedpara_tanh":
        return compose
    gram = {"f16": 0.0, "f32": 2.0 * rows * r * r * (m + n)
            + (2.0 * rows * r * (m + n) if kind == "pfedpara" else 0.0)}
    return min((compose, gram),
               key=lambda c: bound_ms(0.0, c["f16"], c["f32"])[0])


def dfactors_ops(rows: int, m: int, n: int, r: int, x_bits: int = 16) -> dict:
    """The operations of all four factor gradients (K4, both sides):
    dW = xᵀdy once (2·rows·mn, in x's type), W1 and W2 composed once
    (4mnr fp32) and the four rank-r contractions G1·Y1, G2·Y2, G1ᵀ·X1,
    G2ᵀ·X2 (8mnr fp32); the elementwise chain rule (a few per weight)
    is left out. No cheaper route is known at these row counts: the
    Gram-style expansion costs 2·rows·r²·n per contraction."""
    dw = 2.0 * rows * m * n
    if x_bits == 16:
        return {"f16": dw, "f32": 12.0 * m * n * r}
    return {"f16": 0.0, "f32": dw + 12.0 * m * n * r}


# ------------------------------------------------------------ phase 1

def ptxas_entries(log: str) -> list:
    """One dict per kernel of an ``nvcc -Xptxas -v`` log: the entry
    function (mangled), its registers, stack frame and spill bytes."""
    out = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            out.append({"function": ln.split("'")[1]})
        elif out and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[-1].update(stack=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
        elif out and "Used" in ln and "registers" in ln:
            out[-1]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = sorted({ln.strip() for info in built.values()
                    for ln in str(info["log"]).splitlines()
                    if "registers" in ln or "spill" in ln})
    fused = ptxas_entries(str(built.get("fedpara_matmul", {}).get("log", "")))
    serve = ptxas_entries(str(built.get("serve_matmul", {}).get("log", "")))
    grad = ptxas_entries(str(built.get("fedpara_grad", {}).get("log", "")))
    for name in build.SOURCES:
        build.library(name)
    serve_smem = _serve_smem()
    grad_smem = _grad_smem()
    say("build", seconds=round(secs, 3), built=sorted(built),
        ptxas=ptxas[:40], fedpara_matmul_ptxas=fused,
        serve_matmul_ptxas=serve, serve_smem_bytes=serve_smem,
        fedpara_grad_ptxas=grad, fedpara_grad_smem_bytes=grad_smem)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    print(card, flush=True)
    return card, {"seconds": secs, "built": sorted(built), "ptxas": ptxas,
                  "fedpara_matmul_ptxas": fused, "serve_matmul_ptxas": serve,
                  "serve_smem_bytes": serve_smem,
                  "fedpara_grad_ptxas": grad,
                  "fedpara_grad_smem_bytes": grad_smem}


def _serve_smem() -> dict:
    """Dynamic shared memory per block of K8 and K9/K10 (ptxas reports
    static shared memory only) at the main path's configurations: K8 at
    4 (decode) and 512 (prefill) rows, K10 at 1 and 128 rows per user at
    qwen3-8b's largest rank; bf16 and fp32 activations, int8 and fp16
    caches."""
    from repro_torch.kernels import serve_matmul as sm

    out = {}
    for xd, xn in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for wd, wn in ((torch.int8, "int8"), (torch.float16, "fp16")):
            for rows in (4, 512):
                out[f"w8 rows={rows} {xn} {wn}"] = sm.smem_bytes(
                    "w8", rows, 0, xd, wd)
            for t in (1, 128):
                out[f"resid t={t} r=211 {xn} {wn}"] = sm.smem_bytes(
                    "resid", t, 211, xd, wd)
    return out


def _grad_smem() -> dict:
    """Dynamic shared memory per block of K4 (both forms) at the ranks
    the main path and phase 2 give it: qwen3-8b's, the MLP's, 300 and
    the large-rank form's 505, bf16 and fp32 activations."""
    from repro_torch.kernels import fedpara_grad as fg

    return {f"r={r} {n}": fg.smem_bytes(r, dt)
            for r in (160, 70, 211, 300, 505, 40, 4)
            for dt, n in ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))}


# ------------------------------------------------------------ phase 2

def _factors(gen, m, n, r, kind="fedpara"):
    from repro_torch.core import parameterization as par

    node = par.init_linear(gen, m, n, kind=kind, rank=r, device="cuda")
    return node["x1"], node["y1"], node["x2"], node["y2"]


def phase_kernels(clock: Clock, quick: bool):
    """Every kernel against its plain version; returns per-kernel case
    lists (one dict per shape)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.nn.layers import quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(123)
    shapes = dict(list(DISTINCT.items())[:1]) if quick else DISTINCT
    rows_list = (4,) if quick else (4, 512)
    cases = {k: [] for k in ops.KERNELS}

    def record(kernel, name, fn, plain, lib, tol, nbytes, f16=0.0, f32=0.0,
               timed=True, elem=0.0):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):   # K4 returns one tensor per factor
            got, want = (got,), (want,)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{kernel} {name}: non-finite")
        err = max(rel_err(g, w) for g, w in zip(got, want))
        check(err <= tol, f"{kernel} {name}: rel err {err:.3e} > {tol}")
        row = {"case": name, "rel_err": err,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "tol": tol}
        b, by = bound_ms(nbytes, f16, f32, elem)
        row.update(bound_ms=b, bound_by=by)
        if timed and not quick:
            row.update(ms=clock(fn), plain_ms=clock(plain, 3),
                       library_ms=clock(lib) if lib else None)
        cases[kernel].append(row)
        say("kernel", kernel=kernel, **row)

    for pname, (m, n, r) in shapes.items():
        x1, y1, x2, y2 = _factors(gen, m, n, r)
        w = ref.fedpara_compose_ref(x1, y1, x2, y2, kind="fedpara",
                                    out_dtype=torch.float32)
        q = quantize_int8(w)
        wq, s = q["w_q"], q["scale"]
        w16 = w.half()
        wdq = (wq.float() * s).to(torch.bfloat16)
        del w
        for rows in rows_list:
            x = torch.randn((rows, m), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            io = rows * (m + n) * 2
            tag = f"{pname} {m}x{n} r={r} rows={rows}"
            # K8, int8 and fp16 caches
            record("w8_matmul", f"{tag} int8",
                   lambda: ops.w8_matmul(x, wq, s),
                   lambda: ref.w8_matmul_ref(x, wq, s),
                   lambda: torch.matmul(x, wdq), 1e-2,
                   io + m * n + 4 * n, f16=2.0 * rows * m * n)
            w16b = w16.to(torch.bfloat16)
            record("w8_matmul", f"{tag} fp16",
                   lambda: ops.w8_matmul(x, w16),
                   lambda: ref.w8_matmul_ref(x, w16),
                   lambda: torch.matmul(x, w16b), 1e-2,
                   io + 2 * m * n, f16=2.0 * rows * m * n)
            # K1, three kinds (fedpara timed: the main path's kind)
            for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
                wk = ref.fedpara_compose_ref(x1, y1, x2, y2, kind=kind,
                                             out_dtype=torch.bfloat16)
                fo = fedpara_ops(rows, m, n, r, kind)
                record("fedpara_matmul", f"{tag} {kind}",
                       lambda kind=kind: ops.fedpara_matmul(
                           x, x1, y1, x2, y2, kind=kind),
                       lambda kind=kind: ref.fedpara_matmul_ref(
                           x, x1, y1, x2, y2, kind=kind),
                       lambda wk=wk: torch.matmul(x, wk), 1e-2,
                       io + 4 * 2 * r * (m + n), f16=fo["f16"],
                       f32=fo["f32"], timed=kind == "fedpara")
                del wk
            # K10: 4 users against the shared W1 cache (int8)
            U, t = 4, rows // 4
            w1 = x1 @ y1.T
            q1 = quantize_int8(w1)
            ux2 = torch.stack([x2 * (1 + 0.1 * u) for u in range(U)])
            uy2 = torch.stack([y2 * (1 - 0.1 * u) for u in range(U)])
            xu = x.reshape(U, t, m)
            wu = ((q1["w_q"].float() * q1["scale"])[None]
                  * (torch.einsum("umr,unr->umn", ux2, uy2) + 1.0)
                  ).to(torch.bfloat16)
            record("cache_residual_matmul", f"{tag} users=4 int8",
                   lambda: ops.cache_residual_matmul(
                       xu, q1["w_q"], q1["scale"], ux2, uy2),
                   lambda: ref.cache_residual_ref(
                       xu, q1["w_q"], q1["scale"], ux2, uy2),
                   lambda: torch.bmm(xu, wu), 1e-2,
                   io + m * n + 4 * n + U * 2 * r * (m + n) * 4,
                   f16=2.0 * rows * m * n, f32=U * 2.0 * m * n * r)
            del wu, w1
            # the fp32 builds of K8 and K1 that phases 4 and 6 run, at
            # the same full-width shapes: fp32 against fp32, so the
            # tolerance is that of the ragged fp32 cases
            x32 = torch.randn((rows, m), generator=gen, device="cuda")
            io32 = rows * (m + n) * 4
            tag32 = f"{pname} {m}x{n} r={r} fp32 rows={rows}"
            record("w8_matmul", f"{tag32} int8",
                   lambda: ops.w8_matmul(x32, wq, s),
                   lambda: ref.w8_matmul_ref(x32, wq, s), None, 1e-5,
                   io32 + m * n + 4 * n, f32=2.0 * rows * m * n, timed=False)
            record("w8_matmul", f"{tag32} fp16",
                   lambda: ops.w8_matmul(x32, w16),
                   lambda: ref.w8_matmul_ref(x32, w16), None, 1e-5,
                   io32 + 2 * m * n, f32=2.0 * rows * m * n, timed=False)
            for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
                fo = fedpara_ops(rows, m, n, r, kind, x_bits=32)
                record("fedpara_matmul", f"{tag32} {kind}",
                       lambda kind=kind: ops.fedpara_matmul(
                           x32, x1, y1, x2, y2, kind=kind),
                       lambda kind=kind: ref.fedpara_matmul_ref(
                           x32, x1, y1, x2, y2, kind=kind), None, 1e-5,
                       io32 + 4 * 2 * r * (m + n), f16=fo["f16"],
                       f32=fo["f32"], timed=False)
            del x32
        _compose_cases(record, gen, pname, m, n, r, (x1, y1, x2, y2),
                       quick)
        if not quick:
            _backward_cases(record, gen, pname, m, n, r, (x1, y1, x2, y2))
            _client_cases(record, gen, pname, m, n, r)
        # K9: one user, 2-D activations, fp16 cache
        x = torch.randn((4, m), generator=gen, device="cuda").to(torch.bfloat16)
        w1h = (x1 @ y1.T).half()
        w1u = (w1h.float() * (x2 @ y2.T + 1.0)).to(torch.bfloat16)
        record("cache_residual_matmul", f"{pname} {m}x{n} r={r} rows=4 "
               "single-user fp16",
               lambda: ops.cache_residual_matmul(x, w1h, None, x2, y2),
               lambda: ref.cache_residual_ref(x, w1h, None, x2, y2),
               lambda: torch.matmul(x, w1u), 1e-2,
               4 * (m + n) * 2 + 2 * m * n + 2 * r * (m + n) * 4,
               f16=8.0 * m * n, f32=2.0 * m * n * r)
        del w1h, w1u, wq, w16, wdq

    # K3 and K4 at ragged shapes and at the FL MLP's two shapes (K4's fc2
    # side y splits its sweep over 8 blocks), all kinds, fp32 as the FL
    # path runs; K1 at the MLP's shapes too (the ragged loop below holds
    # it at the ragged ones); the MLP's fedpara cases are timed.
    mlp = tuple(MLP_SHAPES.values())
    for rows, m, n, r in ((3, 1000, 1000, 37), (517, 130, 97, 5), *mlp):
        fac = _factors(gen, m, n, r)
        x = torch.randn((rows, m), generator=gen, device="cuda")
        dy = torch.randn((rows, n), generator=gen, device="cuda")
        io = 4 * rows * (m + n)
        for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
            tag = f"fp32 {rows}x{m}x{n} r={r} {kind}"
            timed = (rows, m, n, r) in mlp and kind == "fedpara"
            wt = (ref.fedpara_compose_ref(*fac, kind=kind,
                                          out_dtype=torch.float32)
                  if timed else None)
            fo = fedpara_ops(rows, m, n, r, kind, x_bits=32)
            if (rows, m, n, r) in mlp:
                record("fedpara_matmul", tag,
                       lambda kind=kind: ops.fedpara_matmul(x, *fac,
                                                            kind=kind),
                       lambda kind=kind: ref.fedpara_matmul_ref(x, *fac,
                                                                kind=kind),
                       (lambda wt=wt: torch.matmul(x, wt)) if timed else None,
                       1e-5, io + 8 * r * (m + n), f16=fo["f16"],
                       f32=fo["f32"], timed=timed)
            record("fedpara_dx", tag,
                   lambda kind=kind: ops.fedpara_dx(dy, *fac, kind=kind),
                   lambda kind=kind: ref.fedpara_dx_ref(dy, *fac, kind=kind),
                   (lambda wt=wt: torch.matmul(dy, wt.T)) if timed else None,
                   1e-5, io + 8 * r * (m + n), f16=fo["f16"], f32=fo["f32"],
                   timed=timed)
            do = dfactors_ops(rows, m, n, r, x_bits=32)
            record("fedpara_dfactors", tag,
                   lambda kind=kind: _both_sides(ops.fedpara_dfactors, x, dy,
                                                 fac, kind),
                   lambda kind=kind: _both_sides(ref.fedpara_dfactors_ref, x,
                                                 dy, fac, kind),
                   None, 1e-5, io + 16 * r * (m + n), f16=do["f16"],
                   f32=do["f32"], timed=timed)
    # the client-stacked forms at ragged shapes and at the MLP's shapes
    # for 8 clients of 64 rows (the batched engine's calls), fp32
    for C, rows, m, n, r in ((3, 5, 1000, 1000, 37), (2, 517, 130, 97, 5),
                             *((8, *s) for s in mlp)):
        _client_stack_cases(record, gen, f"fp32 C={C}x{rows} {m}x{n} r={r}",
                            C, rows, m, n, r, torch.float32, 1e-5,
                            timed=(rows, m, n, r) in mlp)
    _agg_cases(record, gen, quick)
    _compose_ragged_cases(record, gen)
    _serve_ragged_cases(record, gen)
    _decode_ragged_cases(record, gen)
    _dfactors_edge_cases(record, gen)
    cases["repeat_bitwise"] = [_repeat_checks(gen)]
    if quick:
        return cases
    # ragged fp32 shapes: every edge masked, tighter tolerance
    for rows, m, n, r in ((3, 1000, 1000, 37), (517, 130, 97, 5)):
        x1, y1, x2, y2 = _factors(gen, m, n, r)
        x = torch.randn((rows, m), generator=gen, device="cuda")
        q = quantize_int8(x1 @ y1.T)
        tag = f"ragged {rows}x{m}x{n} r={r} fp32"
        record("w8_matmul", tag, lambda: ops.w8_matmul(x, q["w_q"], q["scale"]),
               lambda: ref.w8_matmul_ref(x, q["w_q"], q["scale"]), None, 1e-5,
               0, timed=False)
        for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
            record("fedpara_matmul", f"{tag} {kind}",
                   lambda kind=kind: ops.fedpara_matmul(x, x1, y1, x2, y2,
                                                        kind=kind),
                   lambda kind=kind: ref.fedpara_matmul_ref(x, x1, y1, x2, y2,
                                                            kind=kind),
                   None, 1e-5, 0, timed=False)
        xu = x[: (rows // 3) * 3].reshape(3, rows // 3, m)
        ux2 = torch.stack([x2, 0.5 * x2, -x2])
        uy2 = torch.stack([y2, y2, 0.3 * y2])
        record("cache_residual_matmul", f"{tag} users=3",
               lambda: ops.cache_residual_matmul(xu, q["w_q"], q["scale"],
                                                 ux2, uy2),
               lambda: ref.cache_residual_ref(xu, q["w_q"], q["scale"],
                                              ux2, uy2), None, 1e-5, 0,
               timed=False)
    return cases


def _serve_ragged_cases(record, gen):
    """K8 at prefill widths on its tensor-core kernel (rows 33, 100 and
    517; m and n ragged, rows of x or of the cache not 16-byte aligned in
    some: the masked narrower copies), int8 and fp16 caches, bf16 (1e-2)
    and fp32 (1e-5) activations; and K10 at 1, 17 and 129 rows per user
    with each user's factor slab read through a strided view (user
    stride > m·r, as the serve arena's layer-stacked slabs are), fp32
    activations, int8 and fp16 caches, at 1e-5."""
    from repro_torch.kernels import ops, ref
    from repro_torch.nn.layers import quantize_int8

    for rows, m, n in ((33, 1000, 1000), (100, 130, 97), (517, 4096, 1000)):
        w = torch.randn((m, n), generator=gen, device="cuda")
        q = quantize_int8(w)
        caches = (("int8", q["w_q"], q["scale"]), ("fp16", w.half(), None))
        for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            x = torch.randn((rows, m), generator=gen, device="cuda").to(dt)
            for cname, wc, sc in caches:
                record("w8_matmul", f"ragged {rows}x{m}x{n} {_DT_NAME[dt]} "
                       f"{cname}", lambda x=x, wc=wc, sc=sc: ops.w8_matmul(
                           x, wc, sc),
                       lambda x=x, wc=wc, sc=sc: ref.w8_matmul_ref(x, wc, sc),
                       None, tol, 0, timed=False)
    for U, t, m, n, r in ((4, 1, 4096, 1024, 70), (3, 17, 1000, 1000, 37),
                          (2, 129, 520, 300, 211)):
        x1, y1, x2, y2 = _factors(gen, m, n, r)
        w1 = x1 @ y1.T
        q = quantize_int8(w1)
        big_x2 = torch.stack([torch.stack([x2 * (1 - 0.2 * u), -x2])
                              for u in range(U)])          # (U, 2, m, r)
        big_y2 = torch.stack([torch.stack([y2, 0.5 * y2, y2 * (1 + 0.1 * u)])
                              for u in range(U)])          # (U, 3, n, r)
        ux2, uy2 = big_x2[:, 0], big_y2[:, 2]
        check(ux2.stride(0) > m * r and uy2.stride(0) > n * r,
              "strided user slabs")
        x = torch.randn((U, t, m), generator=gen, device="cuda")
        for cname, wc, sc in (("int8", q["w_q"], q["scale"]),
                              ("fp16", w1.half(), None)):
            record("cache_residual_matmul",
                   f"strided U={U} t={t} {m}x{n} r={r} fp32 {cname}",
                   lambda wc=wc, sc=sc: ops.cache_residual_matmul(
                       x, wc, sc, ux2, uy2),
                   lambda wc=wc, sc=sc: ref.cache_residual_ref(
                       x, wc, sc, ux2, uy2), None, 1e-5, 0, timed=False)


# tolerance of the compose kernels by output type: fp32 sums in another
# order; one fp16 ulp (2^-10 of the largest weight); one bf16 ulp (2^-7)
COMPOSE_TOL = {torch.float32: 1e-5, torch.float16: 1e-3,
               torch.bfloat16: 1e-2}
_DT_NAME = {torch.float32: "fp32", torch.float16: "fp16",
            torch.bfloat16: "bf16"}


def _compose_case(record, tag, fac, kind, dt, timed):
    """K5 (2-D factors) or K6 (stacked) against the plain compose, W in
    ``dt``; bound: the compose's fp32 operations, or the factor reads
    and W's write, whichever is longer."""
    from repro_torch.kernels import ops, ref

    lead = fac[0].shape[0] if fac[0].ndim == 3 else 1
    m, r = fac[0].shape[-2:]
    n = fac[1].shape[-2]
    kernel = "fedpara_compose" + ("_stacked" if fac[0].ndim == 3 else "")
    nbytes = lead * (4 * 2 * r * (m + n) + dt.itemsize * m * n)
    record(kernel, f"{tag} {_DT_NAME[dt]} {kind}",
           lambda: ops.fedpara_compose(*fac, kind=kind, out_dtype=dt),
           lambda: ref.fedpara_compose_ref(*fac, kind=kind, out_dtype=dt),
           None, COMPOSE_TOL[dt], nbytes, f32=lead * compose_ops(m, n, r),
           timed=timed)


def _compose_cases(record, gen, pname, m, n, r, fac, quick):
    """K5 at one full-width projection: fp32 W for all kinds (fedpara
    timed: the int8 cache's compose), fp16 and bf16 W; K6 on the
    projection's factors stacked over 2 and 4 layers (pfedpara to fp16
    W over 2 layers timed: phase 10's fp16 cache) and over the 36 layers
    of phase 4's fp16 cache (fedpara to fp16 W, timed), the slab offsets
    there past 2^32 bytes; no library call computes it."""
    tag = f"{pname} {m}x{n} r={r}"
    for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
        _compose_case(record, tag, fac, kind, torch.float32,
                      timed=kind == "fedpara")
    for dt in (torch.float16, torch.bfloat16):
        _compose_case(record, tag, fac, "fedpara", dt, timed=False)
    if quick:
        return
    for L in (*STACK_LAYERS, MAIN_STACK):
        per = [_factors(gen, m, n, r) for _ in range(L - 1)]
        stack = tuple(torch.stack([f, *(p[i] for p in per)])
                      for i, f in enumerate(fac))
        del per
        if L == MAIN_STACK:
            _compose_case(record, f"{tag} L={L}", stack, "fedpara",
                          torch.float16, timed=True)
        else:
            for dt in (torch.float16, torch.float32):
                _compose_case(record, f"{tag} L={L}", stack, "fedpara", dt,
                              timed=False)
            _compose_case(record, f"{tag} L={L}", stack, "pfedpara",
                          torch.float16, timed=L == STACK_LAYERS[0])
        del stack
        torch.cuda.empty_cache()


def _compose_ragged_cases(record, gen):
    """K5 and K6 at the reference tests' ragged shapes
    (``tests/test_kernels.py``, ``tests/test_fl_batched.py``): every
    edge masked, all kinds, fp32 W (fp16 too for the stacked form)."""
    for m, n, r in ((64, 64, 4), (100, 52, 3), (256, 256, 16),
                    (300, 128, 9)):
        fac = _factors(gen, m, n, r)
        for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
            _compose_case(record, f"ragged {m}x{n} r={r}", fac, kind,
                          torch.float32, timed=False)
    fac = _client_factors(gen, 2, 96, 130, 4)
    for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
        for dt in (torch.float32, torch.float16):
            _compose_case(record, "ragged C=2 96x130 r=4", fac, kind, dt,
                          timed=False)


def _both_sides(fn, x, dy, fac, kind):
    """K4's function: (dX1, dX2, dY1, dY2), one call per side."""
    return (*fn(x, dy, *fac, side="x", kind=kind),
            *fn(x, dy, *fac, side="y", kind=kind))


def _backward_cases(record, gen, pname, m, n, r, fac):
    """K3 and K4 at one full-width projection, 512 rows (a prefill-sized
    training batch): bf16, all kinds, fedpara timed (plain version and,
    for K3, one ``torch.matmul`` on the composed W); fp32 untimed at the
    fp32 tolerance."""
    from repro_torch.kernels import ops, ref

    rows = 512
    tag = f"{pname} {m}x{n} r={r} rows={rows}"
    io = rows * (m + n) * 2
    for dt, tol, tdt in ((torch.bfloat16, 1e-2, ""), (torch.float32, 1e-5,
                                                      " fp32")):
        x = torch.randn((rows, m), generator=gen, device="cuda").to(dt)
        dy = torch.randn((rows, n), generator=gen, device="cuda").to(dt)
        bits = 16 if dt == torch.bfloat16 else 32
        io_dt = io * bits // 16
        for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
            timed = kind == "fedpara" and dt == torch.bfloat16
            wt = (ref.fedpara_compose_ref(*fac, kind=kind, out_dtype=dt)
                  if timed else None)
            # K4 is timed in fp32 too: the precision phase 7 trains in
            fo = fedpara_ops(rows, m, n, r, kind, x_bits=bits)
            record("fedpara_dx", f"{tag}{tdt} {kind}",
                   lambda kind=kind: ops.fedpara_dx(dy, *fac, kind=kind),
                   lambda kind=kind: ref.fedpara_dx_ref(dy, *fac, kind=kind),
                   (lambda wt=wt: torch.matmul(dy, wt.T)) if timed else None,
                   tol, io_dt + 8 * r * (m + n), f16=fo["f16"], f32=fo["f32"],
                   timed=timed)
            del wt
            do = dfactors_ops(rows, m, n, r, x_bits=bits)
            record("fedpara_dfactors", f"{tag}{tdt} {kind}",
                   lambda kind=kind: _both_sides(ops.fedpara_dfactors, x, dy,
                                                 fac, kind),
                   lambda kind=kind: _both_sides(ref.fedpara_dfactors_ref, x,
                                                 dy, fac, kind),
                   None, tol, io_dt + 16 * r * (m + n), f16=do["f16"],
                   f32=do["f32"], timed=kind == "fedpara")


def _dfactors_edge_cases(record, gen):
    """K4 at the edges of its tiling, both forms, both sides, all kinds,
    bf16 (1e-2) and fp32 (1e-5): batches of 1, 33 and 100 rows; own and
    other axes that are not multiples of its 32-row and 32-column tiles;
    ranks 1, 7 and 300 (above 256: 16 own rows a block), 337 and 505
    (above 336: the factors read from global memory) and 1100 (three
    rank blocks); then 1, 3 and 8 clients. Last, the gate projection at
    r = 505 (γ = 0.3 at qwen3-8b's widths), 512 rows of bf16, timed."""
    from repro_torch.kernels import ops, ref

    cases = [(0, 1, 130, 97, 5), (0, 33, 1000, 1000, 7), (0, 100, 300, 200, 300),
             (0, 33, 520, 300, 1), (1, 33, 300, 200, 37), (3, 100, 130, 97, 7),
             (8, 1, 520, 300, 300), (0, 33, 300, 200, 337), (0, 100, 130, 97, 505),
             (3, 33, 130, 97, 505), (0, 17, 100, 70, 1100)]
    for C, B, m, n, r in cases:
        fac = (_client_factors(gen, C, m, n, r) if C else _factors(gen, m, n, r))
        lead = (C,) if C else ()
        kernel = "fedpara_dfactors" + ("_clients" if C else "")
        for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            x = torch.randn((*lead, B, m), generator=gen, device="cuda").to(dt)
            dy = torch.randn((*lead, B, n), generator=gen, device="cuda").to(dt)
            for kind in ("fedpara", "fedpara_tanh", "pfedpara"):
                record(kernel, f"edge C={C} B={B} {m}x{n} r={r} {_DT_NAME[dt]} "
                       f"{kind}",
                       lambda x=x, dy=dy, kind=kind: _both_sides(
                           ops.fedpara_dfactors, x, dy, fac, kind),
                       lambda x=x, dy=dy, kind=kind: _both_sides(
                           ref.fedpara_dfactors_ref, x, dy, fac, kind),
                       None, tol, 0, timed=False)
    m, n, _ = SHAPES["w_gate"]
    r, rows = 505, 512
    fac = _factors(gen, m, n, r)
    x = torch.randn((rows, m), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((rows, n), generator=gen, device="cuda").to(torch.bfloat16)
    do = dfactors_ops(rows, m, n, r)
    record("fedpara_dfactors", f"edge w_gate {m}x{n} r={r} rows={rows} fedpara",
           lambda: _both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara"),
           lambda: _both_sides(ref.fedpara_dfactors_ref, x, dy, fac, "fedpara"),
           None, 1e-2, rows * (m + n) * 2 + 16 * r * (m + n), f16=do["f16"],
           f32=do["f32"])


def _decode_ragged_cases(record, gen):
    """K8's decode kernel at 1, 4, 17 and 32 rows, n = 1000 (not a
    multiple of its 128-column blocks nor of an int8 cache's 16-byte
    vectors) and m = 4096 or 1001 (x's rows not 16-byte aligned): int8
    and fp16 caches, bf16 (1e-2) and fp32 (1e-5) activations."""
    from repro_torch.kernels import ops, ref
    from repro_torch.nn.layers import quantize_int8

    for m in (4096, 1001):
        w = torch.randn((m, 1000), generator=gen, device="cuda")
        q = quantize_int8(w)
        caches = (("int8", q["w_q"], q["scale"]), ("fp16", w.half(), None))
        for rows in (1, 4, 17, 32):
            for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
                x = torch.randn((rows, m), generator=gen, device="cuda").to(dt)
                for cname, wc, sc in caches:
                    record("w8_matmul", f"decode {rows}x{m}x1000 "
                           f"{_DT_NAME[dt]} {cname}",
                           lambda x=x, wc=wc, sc=sc: ops.w8_matmul(x, wc, sc),
                           lambda x=x, wc=wc, sc=sc: ref.w8_matmul_ref(x, wc, sc),
                           None, tol, 0, timed=False)


def _repeat_checks(gen) -> dict:
    """Two launches give the same bits: K4 (2-D, a side whose sweep is
    split over blocks, with a client axis, and the large-rank form at
    r = 1100) and K8's decode kernel
    (split over blocks), each at full width; the split counts are
    reported beside."""
    from repro_torch.kernels import fedpara_grad as fg
    from repro_torch.kernels import ops, serve_matmul as sm
    from repro_torch.nn.layers import quantize_int8

    out = {}
    m, n, r = SHAPES["wk"]
    fac = _factors(gen, m, n, r)
    x = torch.randn((512, m), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((512, n), generator=gen, device="cuda").to(torch.bfloat16)
    a = _both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara")
    b = _both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara")
    out["fedpara_dfactors"] = all(torch.equal(u, v) for u, v in zip(a, b))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["fedpara_dfactors_splits_side_y"] = fg._splits(
        1, n, m, r, fg.X_CODES[torch.bfloat16], sms)
    cfac = _client_factors(gen, CLIENTS, m, n, r)
    x = torch.randn((CLIENTS, CLIENT_ROWS, m), generator=gen,
                    device="cuda").to(torch.bfloat16)
    dy = torch.randn((CLIENTS, CLIENT_ROWS, n), generator=gen,
                     device="cuda").to(torch.bfloat16)
    a = _both_sides(ops.fedpara_dfactors, x, dy, cfac, "fedpara")
    b = _both_sides(ops.fedpara_dfactors, x, dy, cfac, "fedpara")
    out["fedpara_dfactors_clients"] = all(torch.equal(u, v)
                                          for u, v in zip(a, b))
    # the large-rank form: three rank blocks, fp32
    fac = _factors(gen, 130, 97, 1100)
    x = torch.randn((33, 130), generator=gen, device="cuda")
    dy = torch.randn((33, 97), generator=gen, device="cuda")
    a = _both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara")
    b = _both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara")
    out["fedpara_dfactors_r1100"] = all(torch.equal(u, v) for u, v in zip(a, b))
    q = quantize_int8(torch.randn((m, n), generator=gen, device="cuda"))
    xd = torch.randn((4, m), generator=gen, device="cuda").to(torch.bfloat16)
    out["w8_matmul_decode"] = torch.equal(ops.w8_matmul(xd, q["w_q"], q["scale"]),
                                          ops.w8_matmul(xd, q["w_q"], q["scale"]))
    out["w8_matmul_decode_splits"] = sm._splits(
        "repro_w8_splits", 4, m, n, sm.X_CODES[torch.bfloat16],
        sm.W_CODES[torch.int8], sms)
    torch.cuda.synchronize()
    check(out["w8_matmul_decode_splits"] > 1
          and out["fedpara_dfactors_splits_side_y"] > 1,
          f"the repeat checks must cover split launches: {out}")
    bad = [k for k, v in out.items() if v is False]
    check(not bad, f"two launches gave different bits: {bad}")
    say("repeat_bitwise", **out)
    return out


def _client_factors(gen, C, m, n, r, kind="fedpara"):
    """C clients' factors, each client's own draw (C, m, r) / (C, n, r)."""
    per = [_factors(gen, m, n, r, kind) for _ in range(C)]
    return tuple(torch.stack(f) for f in zip(*per))


def _client_stack_cases(record, gen, tag, C, rows, m, n, r, dt, tol,
                        timed, kinds=("fedpara", "fedpara_tanh", "pfedpara")):
    """K2, K3 and K4 (both sides) with a client axis on C clients of
    ``rows`` rows: every kind against its plain version; fedpara timed
    (``timed``) with one ``torch.bmm`` on the composed W stack as K2's
    and K3's yardstick."""
    from repro_torch.kernels import ops, ref

    fac = _client_factors(gen, C, m, n, r)
    x = torch.randn((C, rows, m), generator=gen, device="cuda").to(dt)
    dy = torch.randn((C, rows, n), generator=gen, device="cuda").to(dt)
    bits = 16 if dt == torch.bfloat16 else 32
    io = C * rows * (m + n) * bits // 8
    fbytes = C * 4 * 2 * r * (m + n)
    for kind in kinds:
        t = timed and kind == "fedpara"
        wt = (ref.fedpara_compose_ref(*fac, kind=kind, out_dtype=dt)
              if t else None)
        fo = fedpara_ops(rows, m, n, r, kind, x_bits=bits)
        record("fedpara_matmul_clients", f"{tag} {kind}",
               lambda kind=kind: ops.fedpara_matmul(x, *fac, kind=kind),
               lambda kind=kind: ref.fedpara_matmul_ref(x, *fac, kind=kind),
               (lambda wt=wt: torch.bmm(x, wt)) if t else None, tol,
               io + fbytes, f16=C * fo["f16"], f32=C * fo["f32"], timed=t)
        record("fedpara_dx_clients", f"{tag} {kind}",
               lambda kind=kind: ops.fedpara_dx(dy, *fac, kind=kind),
               lambda kind=kind: ref.fedpara_dx_ref(dy, *fac, kind=kind),
               (lambda wt=wt: torch.bmm(dy, wt.mT)) if t else None, tol,
               io + fbytes, f16=C * fo["f16"], f32=C * fo["f32"], timed=t)
        del wt
        do = dfactors_ops(rows, m, n, r, x_bits=bits)
        record("fedpara_dfactors_clients", f"{tag} {kind}",
               lambda kind=kind: _both_sides(ops.fedpara_dfactors, x, dy,
                                             fac, kind),
               lambda kind=kind: _both_sides(ref.fedpara_dfactors_ref, x, dy,
                                             fac, kind),
               None, tol, io + 2 * fbytes, f16=C * do["f16"],
               f32=C * do["f32"], timed=t)


def _client_cases(record, gen, pname, m, n, r):
    """The client-stacked kernels at one full-width projection: 4
    clients x 128 rows, bf16 (fedpara timed) at 1e-2, then fp32 at
    1e-5."""
    tag = f"{pname} {m}x{n} r={r}"
    _client_stack_cases(record, gen, f"{tag} C={CLIENTS}x{CLIENT_ROWS}",
                        CLIENTS, CLIENT_ROWS, m, n, r, torch.bfloat16, 1e-2,
                        timed=True)
    _client_stack_cases(record, gen, f"{tag} fp32 C={CLIENTS}x{CLIENT_ROWS}",
                        CLIENTS, CLIENT_ROWS, m, n, r, torch.float32, 1e-5,
                        timed=False)
    torch.cuda.empty_cache()


def _agg_cases(record, gen, quick):
    """K7 against its plain version. Full size (unless ``quick``): 16
    clients over one qwen3-8b layer's factors (AGG_L elements), int8,
    fp16 and fp32 wire, timed, ``torch.addmv`` on the fp32 stack as the
    yardstick; then a ragged length read through an unaligned view, zero
    coefficients (which must add exact zeros), and the MLP's leaves at
    the streaming phase's chunk of 3 clients (fp32, the identity
    codec's wire). Tolerance 1e-5 relative: fp32 sums of 16 terms in
    another order."""
    from repro_torch.kernels import ops, ref

    C = AGG_CLIENTS
    coeff = torch.rand((C,), generator=gen, device="cuda") * 40.0
    sizes = () if quick else (("layer", AGG_L),)
    for label, L in (*sizes, ("ragged", 1_000_003)):
        acc0 = torch.randn((L,), generator=gen, device="cuda")
        q8 = torch.randint(-127, 128, (C, L), generator=gen, device="cuda",
                           dtype=torch.int8)
        for qname, q in (("int8", q8), ("fp16", q8.half() / 64),
                         ("fp32", q8.float() / 64)):
            work = acc0.clone()
            qf = q.float() if label == "layer" else None
            record("dequant_acc", f"{label} C={C} L={L} {qname}",
                   lambda q=q, work=work: ops.dequant_acc(work, q, coeff),
                   lambda q=q: ref.dequant_acc_ref(acc0, q, coeff),
                   (lambda qf=qf: torch.addmv(acc0, qf.T, coeff))
                   if qf is not None else None,
                   1e-5, (q.element_size() * C + 8) * L, elem=2.0 * C * L,
                   timed=label == "layer")
            del work, qf
        torch.cuda.empty_cache()
    # a leaf that starts 1 byte past an aligned address, rows L + 1 apart
    L = 4099
    base = torch.randint(-127, 128, (C, L + 1), generator=gen, device="cuda",
                         dtype=torch.int8)
    q = base[:, 1:]
    acc0 = torch.randn((L,), generator=gen, device="cuda")
    work = acc0.clone()
    record("dequant_acc", f"unaligned C={C} L={L} int8",
           lambda: ops.dequant_acc(work, q, coeff),
           lambda: ref.dequant_acc_ref(acc0, q, coeff), None, 1e-5, 0,
           timed=False)
    zero = torch.zeros_like(coeff)
    check(torch.equal(ops.dequant_acc(acc0.clone(), q, zero), acc0),
          "dequant_acc: zero coefficients changed the accumulator")
    pad = coeff.clone()
    pad[C // 2:] = 0.0      # pad slots: coefficient 0 on finite rows
    half = ops.dequant_acc(acc0.clone(), q[: C // 2], coeff[: C // 2])
    check(torch.equal(ops.dequant_acc(acc0.clone(), q, pad), half),
          "dequant_acc: pad slots with coefficient 0 changed the sum")
    # the MLP's leaves at the streaming phase's chunk (identity wire)
    for name, shape in (("fc1.x1", (784, 40)), ("fc1.y1", (256, 40)),
                        ("b1", (256,)), ("fc2.y1", (10, 4)), ("b2", (10,))):
        q = torch.randn((3, *shape), generator=gen, device="cuda")
        acc0 = torch.randn(shape, generator=gen, device="cuda")
        work = acc0.clone()
        w = torch.tensor([40.0, 12.0, 0.0], device="cuda")
        record("dequant_acc", f"mlp {name} C=3 fp32",
               lambda q=q, work=work, w=w: ops.dequant_acc(
                   work.view(-1), q.reshape(3, -1), w),
               lambda q=q, acc0=acc0, w=w: ref.dequant_acc_ref(
                   acc0.view(-1), q.reshape(3, -1), w), None, 1e-5,
               (4 * 3 + 8) * acc0.numel(), timed=False)


# ------------------------------------------------------------ phases 3-6

def _cfg(kind: str, layers: int):
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen3-8b")
    return dataclasses.replace(cfg, n_layers=layers, param=dataclasses.replace(
        cfg.param, kind=kind))


def _prompts(batch: int, length: int, vocab: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, size=(batch, length)))


def _forced(eng, prompts, tokens, user_ids=None):
    """Prefill + decode feeding the given tokens; returns logits per
    step (teacher forcing keeps two engines on identical inputs)."""
    B, S = prompts.shape
    cache = eng.init_cache(B, S + tokens.shape[1])
    cache, logits = eng.prefill(prompts, cache, user_ids)
    out = [logits.float().cpu()]
    for i in range(tokens.shape[1]):
        logits, cache = eng.decode_step(cache, tokens[:, i:i + 1], S + i,
                                        user_ids)
        out.append(logits.float().cpu())
    return out


def phase_serve(params, measurements):
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_timed
    from repro_torch.serve import ServeEngine, cost_model

    cfg = _cfg("fedpara", 36)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, mode="precompose", cache_dtype="int8",
                      batch=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(ops.launches()["fedpara_compose"] >= 7 * 36,
          f"K5 composed {ops.launches()['fedpara_compose']} int8 cache "
          "layers, want >= 7 x 36")
    prompts = _prompts(4, 128, cfg.vocab_size, 1)
    rep = serve_timed(eng, prompts, 16)
    torch.cuda.synchronize()
    counts = ops.launches()
    logits = rep["last_logits"]
    check(tuple(logits.shape) == (4, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(int(rep["tokens"].min()) >= 0
          and int(rep["tokens"].max()) < cfg.vocab_size, "token range")
    need = 7 * 36 * (1 + 16)
    check(counts["w8_matmul"] >= need,
          f"K8 launched {counts['w8_matmul']} times, want >= {need}")
    # the cost model's measured branch on the card: both modes of the
    # widest projection at the decode batch, and what `auto` would pick
    meas = cost_model.measure_modes(4096, 12288, 211, 4)
    pick = cost_model.decide("w_gate", 4096, 12288, 211, batch=4,
                             measured=meas)
    out = {"prefill_ms": rep["prefill_ms"], "decode_ms": rep["decode_ms"],
           "decode_profile": _profile_decode(eng, prompts),
           "gate_b4_measured_us": meas, "gate_b4_predicted_us":
           pick.predicted_us, "gate_b4_auto_pick": pick.mode,
           "decode_tok_s": rep["decode_tok_s"],
           "prefill_tok_s": rep["prefill_tok_s"], "build_s": build_s,
           "state_bytes": eng.state_bytes(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "plan": sorted({d["impl"] for d in
                                               eng.decision_table()})}
    say("serve_full_width", layers=36, batch=4, prompt=128, gen=16, **out)
    measurements["serve"] = out
    return counts


def _profile_decode(eng, prompts, steps: int = 2):
    """Device-busy share of decode: :func:`_profile` over ``steps``
    decode steps."""
    B, S = prompts.shape
    cache = eng.init_cache(B, S + steps)
    cache, logits = eng.prefill(prompts, cache)
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()

    def run():
        c = cache
        for i in range(steps):
            _, c = eng.decode_step(c, tok, S + i)

    return {"steps": steps, **_profile(run)}


def _profile(fn):
    """Device-busy share of ``fn()``: the CUDA time ``torch.profiler``
    records against the host wall time, and the kernels that take the
    device time ("not measured" when the profiler sees no device
    activity)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.events():   # device-side events only: no double count
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
    device_us = sum(by_name.values())
    if device_us <= 0:
        return {"device_busy_share": "not measured", "wall_us": wall_us}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_us": wall_us, "device_us": device_us,
            "device_busy_share": device_us / wall_us,
            "top_device_us": [[k[:80], v] for k, v in top]}


def phase_parity(params, measurements):
    """Fused (K1, W composed on chip) against the fp16 cache (K8) on the
    same weights and tokens, with fp32 activations as the reference's
    own serve smoke runs it: the check is about the two weight layouts,
    and in bf16 the rounding of a deep random model's activations alone
    moves logits by about 2e-2 (a CPU run of an 8-layer, d_model 512
    model measured 1.6e-2 to 2.2e-2 in bf16, 1.2e-3 to 1.5e-3 in fp32)."""
    from repro_torch.kernels import ops
    from repro_torch.nn.transformer import ModelOptions
    from repro_torch.serve import ServeEngine

    cfg = _cfg("fedpara", 36)
    opts = ModelOptions(attn_chunk=64, dtype=torch.float32)
    prompts = _prompts(4, 128, cfg.vocab_size, 2)
    ops.reset_launches()
    t0 = time.perf_counter()
    eng16 = ServeEngine(cfg, params, mode="precompose", cache_dtype="fp16",
                        batch=4, opts=opts)
    torch.cuda.synchronize()
    build16_s = time.perf_counter() - t0
    check(ops.launches()["fedpara_compose_stacked"] >= 7,
          f"K6 composed {ops.launches()['fedpara_compose_stacked']} "
          "stacked fp16 cache nodes, want >= 7")
    toks = eng16.generate(prompts, 4)
    want = _forced(eng16, prompts, toks)
    torch.cuda.synchronize()
    counts16 = ops.launches()
    del eng16
    torch.cuda.empty_cache()
    fused = ServeEngine(cfg, params, mode="fused", batch=4, opts=opts)
    ops.reset_launches()
    t0 = time.perf_counter()
    got = _forced(fused, prompts, toks)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launches()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    check(max(errs) < 2e-2, f"fused vs precompose/fp16 rel err {errs}")
    check(counts["fedpara_matmul"] > 0, "K1 never launched in fused mode")
    # the plan is made at the decode batch: the factorized layers decode
    # through the Gram identity, and the 512 prefill rows go through K1
    impls = sorted({d["impl"] for d in fused.decision_table()})
    check([i for i in impls if i != "einsum"] == ["gram"],
          f"fused decode plan {impls}, want the Gram identity")
    say("mode_parity", rel_errs=errs, launches=counts, fused_impls=impls,
        fused_host_s=secs, fp16_cache_build_s=build16_s,
        fp16_launches=counts16)
    measurements["parity"] = {"rel_errs": errs, "launches": counts,
                              "fp16_launches": counts16, "impls": impls,
                              "fp16_cache_build_s": build16_s}
    return {k: counts[k] + counts16[k] for k in counts}


def _merge_user(global_params, local):
    """Overlay a user's x2/y2 onto the global tree (merge-then-plain)."""
    if isinstance(local, dict):
        out = dict(global_params)
        for k, v in local.items():
            out[k] = _merge_user(global_params.get(k, {}), v) \
                if isinstance(v, dict) else v
        return out
    return local


def phase_users(measurements):
    from repro_torch.fl import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import seeded_params, seeded_users
    from repro_torch.nn.transformer import ModelOptions, build_model
    from repro_torch.serve import ServeEngine

    cfg = _cfg("pfedpara", 4)
    params = seeded_params(cfg, 7, "cuda")
    users = seeded_users(params, 4, 7)
    eng = ServeEngine(cfg, params, users, mode="precompose",
                      cache_dtype="int8", batch=4)
    prompts = _prompts(4, 64, cfg.vocab_size, 3)
    uids = [0, 1, 2, 3]
    ops.reset_launches()
    cache = eng.init_cache(4, 64 + 4)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    cache, logits = eng.prefill(prompts, cache, uids)
    ev[1].record()
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(4):
        _, cache = eng.decode_step(cache, tok, 64 + i, uids)
    ev[2].record()
    torch.cuda.synchronize()
    counts = ops.launches()
    prefill_ms, decode_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    check(counts["cache_residual_matmul"] >= 7 * 4 * 5,
          f"K10 launched {counts['cache_residual_matmul']} times")
    # the oracle: merge each user's half, materialize W, fp32 throughout
    plain = build_model(cfg, ModelOptions(use_kernels=False,
                                          dtype=torch.float32))
    glob = comm.split_pfedpara(params)[0]
    errs = []
    for u in uids:
        full = _merge_user(glob, users[u])
        c = plain.init_cache(1, 64, "cuda")
        with torch.no_grad():
            _, want = plain.prefill(full, prompts[u:u + 1].cuda(), c)
        errs.append(rel_err(logits[u:u + 1], want))
    check(max(errs) < 8e-2, f"per-user rel err {errs}")
    say("many_users", users=4, layers=4, launches=counts, rel_errs=errs,
        prefill_ms=prefill_ms, decode_ms=decode_ms, decode_steps=4,
        arena_bytes=eng.arena_bytes(), state_bytes=eng.state_bytes())
    measurements["users"] = {"rel_errs": errs, "launches": counts,
                             "prefill_ms": prefill_ms, "decode_ms": decode_ms}
    return counts


def phase_card_vs_host(measurements):
    """2 full-width layers, fp32 activations: the card's kernels against
    the host's plain versions on the same weights. Tolerance 2e-3
    relative: the two int8 caches are composed separately (fp32 sums in
    another order), so a weight on a rounding boundary may take the
    neighbouring code, and the fp32 accumulation order differs."""
    from repro_torch.launch.serve import seeded_params
    from repro_torch.nn.transformer import ModelOptions
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_map

    cfg = _cfg("fedpara", 2)
    params = seeded_params(cfg, 11, "cuda")
    host = tree_map(lambda t: t.cpu(), params)
    opts = ModelOptions(attn_chunk=64, dtype=torch.float32)
    prompts = _prompts(2, 16, cfg.vocab_size, 4)
    card = ServeEngine(cfg, params, mode="precompose", batch=2, opts=opts)
    toks = card.generate(prompts, 2)
    got = _forced(card, prompts, toks)
    del card, params
    cpu = ServeEngine(cfg, host, mode="precompose", batch=2, opts=opts,
                      device="cpu")
    want = _forced(cpu, prompts, toks)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    check(max(errs) < 2e-3, f"card vs host rel err {errs}")
    say("card_vs_host", layers=2, rel_errs=errs, tol=2e-3)
    measurements["card_vs_host"] = errs


# ------------------------------------------------------------ phases 7-8

def phase_layer_grad(measurements):
    """One full-width qwen3-8b layer's 7 projections at 512 rows, fp32:
    forward and backward through ``FedParaMatmul`` (K1, then K3 and K4)
    against plain autograd through the materialized W, on the same
    inputs and output cotangents. Tolerance 1e-4 relative: fp32 sums of
    up to 12288 x 512 terms taken in another order (the kernels' checks
    in phase 2 measure ~1e-6)."""
    from repro_torch.core import parameterization as par
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(321)
    errs, fused_ms, plain_ms = {}, 0.0, 0.0
    steps = []
    for pname, (m, n, r) in SHAPES.items():
        fac = [t.requires_grad_() for t in _factors(gen, m, n, r)]
        x = torch.randn((512, m), generator=gen, device="cuda"
                        ).requires_grad_()
        cot = torch.randn((512, n), generator=gen, device="cuda")
        leaves = [x, *fac]

        def fused():
            y = ops.fedpara_matmul(x, *fac, kind="fedpara")
            return torch.autograd.grad(y, leaves, cot)

        def plain():
            w = par.materialize(dict(zip(("x1", "y1", "x2", "y2"), fac)),
                                "fedpara")
            return torch.autograd.grad(x @ w, leaves, cot)

        got, want = fused(), plain()
        torch.cuda.synchronize()
        steps.append(fused)
        errs[pname] = [rel_err(g, w) for g, w in zip(got, want)]
        check(max(errs[pname]) < 1e-4,
              f"layer grads {pname}: rel errs {errs[pname]}")
        for fn, acc in ((fused, "fused"), (plain, "plain")):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            if acc == "fused":
                fused_ms += a.elapsed_time(b)
            else:
                plain_ms += a.elapsed_time(b)
    out = {"rel_errs": errs, "fused_fwd_bwd_ms": fused_ms,
           "plain_autograd_ms": plain_ms, "rows": 512, "dtype": "fp32",
           "k4_share": _k4_share(steps)}
    say("layer_grad", **out)
    measurements["layer_grad"] = out


def _k4_share(steps) -> dict:
    """K4's share of the layer's training step: the device time of its
    launches (the factor-gradient kernel and its split sum) against all
    device time, over one pass of the 7 projections' steps under
    ``torch.profiler``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in steps:
            fn()
        torch.cuda.synchronize()
    k4 = total = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total += ev.device_time_total
            if "dfactors" in ev.name or "sum_splits" in ev.name:
                k4 += ev.device_time_total
    if total <= 0:
        return {"k4_device_ms": "not measured", "share": "not measured"}
    return {"k4_device_ms": k4 / 1e3, "device_ms": total / 1e3,
            "share": k4 / total}


def _mlp_init():
    """The MLP's initial weights (784 -> 256 -> 10, fedpara, gamma 0.3),
    drawn on the host from a seed and written for ``--init-params``;
    returns (tree, path)."""
    from repro_torch import interop
    from repro_torch.configs.base import ParamCfg
    from repro_torch.nn import recurrent as rec

    cfg = rec.MLPConfig(in_dim=784, hidden=256, classes=10,
                        param=ParamCfg(kind="fedpara", gamma=0.3,
                                       min_dim_for_factorization=8))
    init = rec.init_mlp_model(torch.Generator().manual_seed(0), cfg)
    shapes = {k: tuple(v.shape) for k, v in init["fc1"].items()}
    check(shapes == {"x1": (784, 40), "y1": (256, 40), "x2": (784, 40),
                     "y2": (256, 40)}, f"fc1 factors {shapes}")
    path = REPO / "build" / "chip_smoke" / "mlp_init.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    interop.save_npz(init, str(path))
    return init, path


def _param_maxdiff(a, b) -> float:
    """Largest |a - b| over two servers' global parameters."""
    from repro_torch.tree import tree_leaves

    return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
               zip(tree_leaves(a["server"].global_params),
                   tree_leaves(b["server"].global_params)))


def _same_rounds(a, b, what: str, keys=("arrived_mask", "sampled",
                                        "down_bytes", "up_bytes",
                                        "comm_gb")) -> None:
    """Two runs' round records agree exactly on ``keys``."""
    for ra, rb in zip(a["server"].history, b["server"].history):
        for k in keys:
            check(ra[k] == rb[k],
                  f"{what} round {ra['round']} {k}: {ra[k]} != {rb[k]}")


def _card_vs_host(card, host, init) -> dict:
    """The card run against the host run of the same command: loss and
    parameters within 1e-4, the reference's engine tolerance (fp32 sums
    in another order on each side); eval within 2e-3, two of its 1000
    test predictions, since one argmax flipped at a near-tie moves it by
    1e-3; and training must have moved the weights."""
    from repro_torch.tree import tree_leaves

    _same_rounds(card, host, "card vs host")
    rc, rh = card["record"], host["record"]
    loss_d = abs(rc["mean_loss"] - rh["mean_loss"])
    eval_d = abs(rc["eval"] - rh["eval"])
    param_d = _param_maxdiff(card, host)
    moved = max(float((a.cpu() - b).abs().max()) for a, b in
                zip(tree_leaves(card["server"].global_params["fc1"]),
                    tree_leaves(init["fc1"])))
    check(moved > 1e-3, f"training moved fc1 by only {moved}")
    check(loss_d < 1e-4, f"card vs host mean_loss differ by {loss_d}")
    check(param_d < 1e-4, f"card vs host params differ by {param_d}")
    check(eval_d <= 2e-3, f"card vs host eval differ by {eval_d}")
    return {"loss_diff": loss_d, "eval_diff": eval_d,
            "param_maxdiff": param_d, "fc1_moved": moved}


def phase_train(measurements):
    """The FL main path of the sequential engine: ``launch/train.py
    --mode fl --model mlp --rounds 3 --clients 20 --use-kernels --engine
    sequential`` (``--lr 0.05`` so the weights move) on the card, and
    the same run on the host with ``--device cpu``, both from one set of
    initial weights drawn on the host and passed with ``--init-params``.
    Masks, sampled clients and wire bytes must be equal, the rest as
    :func:`_card_vs_host` says. Returns the card run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    init, path = _mlp_init()
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "3", "--clients",
            "20", "--use-kernels", "--lr", "0.05", "--init-params", str(path),
            "--engine", "sequential"]
    ops.reset_launches()
    card = train.main(argv)
    counts = ops.launches()
    host = train.main(argv + ["--device", "cpu"])
    for kernel in ("fedpara_matmul", "fedpara_dx", "fedpara_dfactors"):
        check(counts[kernel] > 0, f"{kernel} never launched in FL training")
    rc = card["record"]
    diffs = _card_vs_host(card, host, init)
    loss_d, eval_d = diffs["loss_diff"], diffs["eval_diff"]
    param_d, moved = diffs["param_maxdiff"], diffs["fc1_moved"]
    out = {"round_seconds_card": card["round_seconds"],
           "round_seconds_host": host["round_seconds"],
           "launches": counts, "record": rc, "loss_diff": loss_d,
           "eval_diff": eval_d, "param_maxdiff": param_d,
           "fc1_moved": moved,
           "round_profile": _profile(card["server"].run_round)}
    say("fl_train", **out)
    measurements["train"] = out
    return counts


def phase_engines(measurements):
    """The batched and streaming engines: ``launch/train.py --mode fl
    --model mlp --rounds 3 --clients 50 --use-kernels --lr 0.05`` from
    the same initial weights, with ``--engine batched`` on the card and
    on the host (:func:`_card_vs_host`), and with ``--engine streaming
    --client-chunk 3`` on the card, held to the card's batched run:
    masks, clients and bytes equal, parameters within 1e-4 (chunking
    reassociates the fp32 sum), and its records carry 3 chunks of 3.
    Each card run's launches are counted on its own; the client-stacked
    kernels and K7 must each launch. Returns the card runs' summed
    launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    init, path = _mlp_init()
    argv = ["--mode", "fl", "--model", "mlp", "--rounds", "3", "--clients",
            "50", "--use-kernels", "--lr", "0.05", "--init-params", str(path)]
    runs, counts = {}, {}
    for name, extra in (("batched", ["--engine", "batched"]),
                        ("streaming", ["--engine", "streaming",
                                       "--client-chunk", "3"])):
        ops.reset_launches()
        runs[name] = train.main(argv + extra)
        counts[name] = ops.launches()
    host = train.main(argv + ["--engine", "batched", "--device", "cpu"])
    for kernel in ("fedpara_matmul_clients", "fedpara_dx_clients",
                   "fedpara_dfactors_clients"):
        for name in runs:
            check(counts[name][kernel] > 0,
                  f"{kernel} never launched by the {name} engine")
    check(counts["streaming"]["dequant_acc"] > 0,
          "dequant_acc never launched by the streaming engine")
    check(counts["batched"]["fedpara_matmul"] == 2 * 3,
          f"batched engine: {counts['batched']['fedpara_matmul']} 2-D K1 "
          "launches, want 2 per eval")
    diffs = _card_vs_host(runs["batched"], host, init)
    _same_rounds(runs["streaming"], runs["batched"], "streaming vs batched")
    stream_d = _param_maxdiff(runs["streaming"], runs["batched"])
    check(stream_d < 1e-4, f"streaming vs batched params differ by "
          f"{stream_d}")
    for r in runs["streaming"]["server"].history:
        check((r["chunks"], r["client_chunk"], r["participants"]) ==
              (3, 3, 8), f"streaming round layout {r}")
    out = {"round_seconds_batched_card": runs["batched"]["round_seconds"],
           "round_seconds_streaming_card":
               runs["streaming"]["round_seconds"],
           "round_seconds_batched_host": host["round_seconds"],
           "launches": counts, "record_batched": runs["batched"]["record"],
           "record_streaming": runs["streaming"]["record"],
           "streaming_vs_batched_param_maxdiff": stream_d, **diffs,
           "round_profile_batched": _profile(
               runs["batched"]["server"].run_round),
           "round_profile_streaming": _profile(
               runs["streaming"]["server"].run_round)}
    say("fl_engines", **out)
    measurements["engines"] = out
    return {k: counts["batched"][k] + counts["streaming"][k]
            for k in counts["batched"]}


# ------------------------------------------------------------ phase 10

def _equal_trees(a, b, what: str) -> int:
    """Two trees hold the same paths and bitwise-equal leaves; returns
    the number of leaves compared."""
    from repro_torch.checkpoint.manager import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    check([p for p, _ in fa] == [p for p, _ in fb],
          f"{what}: paths differ")
    for (p, x), (_, y) in zip(fa, fb):
        check(x.dtype == y.dtype and x.shape == y.shape
              and torch.equal(x, y.to(x.device)),
              f"{what}: leaf {p} differs")
    return len(fa)


def phase_checkpoint_serve(card: str, measurements):
    """The checkpoint -> serve path at qwen3-8b's published widths, depth
    cut to 2 layers, ``kind=pfedpara`` at the config's gamma: one round
    of the sequential ``FLServer`` (2 clients, all taking part, FedAvg,
    lr 0.05, batch 8, 12 sequences of 16 tokens each, kernels on, fp32:
    K1, K3, K4), held against the same round with the kernels off (the
    plain versions, on the card) from the same init and data: records
    equal, mean loss and every global and personal parameter within
    1e-4, the reference's engine tolerance, as phase 8 holds the MLP;
    ``save_checkpoint``; ``load_fl_checkpoint`` and a fresh
    server's ``restore_checkpoint``, both bitwise equal to the trained
    server's trees; then served from the checkpoint: the global model
    fused (K1 on the prompt, the Gram identity on decode) against its
    int8 cache (K5, then K8) at 8e-2 and its fp16 cache (K6, then K8) at
    2e-2, and the 2 users precomposed (K10) and fused against each
    user's merge-then-plain logits at 8e-2 and 1e-4, each with 4 decode
    steps. The bounds are the reference's: int8 8e-2 and fused 1e-4
    (``tests/test_serve.py:233-237``), 2e-2 its precompose-vs-fused
    smoke gate, which runs the fp16 cache. The embedding gradient's
    atomics make card training differ from run to run in the last bits,
    so the two rounds agree within the tolerance, and the checkpoint
    restores bitwise."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_token_lm_dataset
    from repro_torch.fl import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_federation, seeded_params
    from repro_torch.nn.transformer import ModelOptions, build_model
    from repro_torch.serve import ServeEngine, load_fl_checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg("pfedpara", 2)
    train_opts = ModelOptions(dtype=torch.float32)
    d = REPO / "build" / "chip_smoke" / "fl_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    free_before = shutil.disk_usage(d).free
    init = seeded_params(cfg, 0, "cuda")
    plain_srv = build_federation(
        cfg, ModelOptions(use_kernels=False, dtype=torch.float32), rounds=1,
        clients=2, device="cuda", params=tree_map(torch.clone, init))
    plain_srv.run()
    ops.reset_launches()
    srv = build_federation(cfg, train_opts, rounds=1, clients=2,
                           device="cuda", params=tree_map(torch.clone, init))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = ops.launches()
    for kernel in ("fedpara_matmul", "fedpara_dx", "fedpara_dfactors"):
        check(counts[kernel] > 0, f"{kernel} never launched in training")
    rec = srv.history[-1]
    check(rec["participants"] == 2 and np.isfinite(rec["mean_loss"]),
          f"training round {rec}")
    _same_rounds({"server": srv}, {"server": plain_srv}, "kernels vs plain")
    loss_d = abs(rec["mean_loss"] - plain_srv.history[-1]["mean_loss"])
    pairs = list(zip(tree_leaves(srv.global_params),
                     tree_leaves(plain_srv.global_params)))
    for u in sorted(plain_srv.local_trees):
        pairs += zip(tree_leaves(srv.local_trees[u]),
                     tree_leaves(plain_srv.local_trees[u]))
    param_d = max(float((a - b).abs().max()) for a, b in pairs)
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(plain_srv.global_params), tree_leaves(init)))
    check(moved > 1e-5, f"training moved the weights by only {moved}")
    check(loss_d < 1e-4, f"kernels vs plain mean_loss differ by {loss_d}")
    check(param_d < 1e-4, f"kernels vs plain params differ by {param_d}")
    vs_plain = {"loss_diff": loss_d, "param_maxdiff": param_d,
                "moved": moved,
                "plain_mean_loss": plain_srv.history[-1]["mean_loss"]}
    del plain_srv, init, pairs
    torch.cuda.empty_cache()

    mgr = CheckpointManager(str(d))
    t0 = time.perf_counter()
    step_dir = Path(srv.save_checkpoint(mgr))
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    t0 = time.perf_counter()
    gp, local, _, step = load_fl_checkpoint(str(d), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == 1 and sorted(local) == [0, 1], f"step {step}, users "
          f"{sorted(local)}")
    n_leaves = _equal_trees(srv.global_params, gp, "global params")
    for u in local:
        n_leaves += _equal_trees(srv.local_trees[u], local[u],
                                 f"user {u}")
    fresh = build_federation(cfg, train_opts, rounds=1, clients=2,
                             device="cuda", params=gp)
    check(fresh.restore_checkpoint(mgr) == 1, "restored step")
    _equal_trees(srv.global_params, fresh.global_params, "fresh server")
    for u in srv.local_trees:
        _equal_trees(srv.local_trees[u], fresh.local_trees[u],
                     f"fresh server user {u}")
    _equal_trees(srv._stale_ref, fresh._stale_ref, "fresh server stale_ref")
    ra, rb = fresh.rng.get_state(), srv.rng.get_state()
    check(fresh.history == srv.history and fresh.round_idx == 1
          and fresh.comm_log.up_bytes == srv.comm_log.up_bytes
          and fresh.comm_log.down_bytes == srv.comm_log.down_bytes
          and ra[0] == rb[0] and np.array_equal(ra[1], rb[1])
          and ra[2:] == rb[2:], "fresh server's host state differs")
    del fresh, srv
    torch.cuda.empty_cache()

    opts = ModelOptions(attn_chunk=64, dtype=torch.float32)
    # prompts from the training data's distribution, 8 tokens, as the
    # reference's checkpoint -> serve test draws them
    prompts = torch.from_numpy(make_token_lm_dataset(2, 8, cfg.vocab_size,
                                                     seed=2)).long()
    # the global model, no users: fused (K1 on the prompt, the Gram
    # identity on decode) against the int8 cache (K5 pfedpara, K8) at
    # the reference's int8 bound and the fp16 cache (K6, K8) at its
    # precompose-vs-fused smoke bound
    ops.reset_launches()
    fused = ServeEngine(cfg, gp, mode="fused", batch=2, opts=opts)
    toks = fused.generate(prompts, 4)
    want = _forced(fused, prompts, toks)
    del fused
    glob_errs, build_s = {}, {}
    for cache_dtype, tol, kernel, need in (
            ("int8", 8e-2, "fedpara_compose", 7 * 2),
            ("fp16", 2e-2, "fedpara_compose_stacked", 7)):
        before = ops.launches()[kernel]
        t0 = time.perf_counter()
        pre = ServeEngine(cfg, gp, mode="precompose", cache_dtype=cache_dtype,
                          batch=2, opts=opts)
        torch.cuda.synchronize()
        build_s[cache_dtype] = time.perf_counter() - t0
        check(ops.launches()[kernel] - before >= need,
              f"{kernel} composed {ops.launches()[kernel] - before} "
              f"{cache_dtype} cache nodes, want >= {need}")
        got = _forced(pre, prompts, toks)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        check(max(errs) < tol, f"global precompose {cache_dtype} vs fused "
              f"rel err {errs} >= {tol}")
        glob_errs[cache_dtype] = errs
        del pre
    # the users: from_checkpoint, int8 cache (K10) and fused, against
    # each user's merged tree through the plain model
    uids = [0, 1]
    plain = build_model(cfg, ModelOptions(use_kernels=False,
                                          dtype=torch.float32))
    glob = comm.split_pfedpara(gp)[0]
    user_errs = {}
    for mode, tol in (("precompose", 8e-2), ("fused", 1e-4)):
        eng = ServeEngine.from_checkpoint(str(d), cfg, mode=mode,
                                          cache_dtype="int8", batch=2,
                                          opts=opts)
        utoks = eng.generate(prompts, 4, uids)
        steps = _forced(eng, prompts, utoks, uids)
        check(all(bool(torch.isfinite(x).all()) for x in steps),
              f"{mode} users: non-finite logits")
        errs = []
        for u in uids:
            full = _merge_user(glob, local[u])
            c = plain.init_cache(1, 8, "cuda")
            with torch.no_grad():
                _, w = plain.prefill(full, prompts[u:u + 1].cuda(), c)
            errs.append(rel_err(steps[0][u:u + 1], w.cpu()))
        check(max(errs) < tol, f"{mode} users vs merge-then-plain {errs} "
              f">= {tol}")
        user_errs[mode] = errs
        del eng
    counts_serve = ops.launches()
    check(counts_serve["cache_residual_matmul"] > 0, "K10 never launched")
    shutil.rmtree(d, ignore_errors=True)
    out = {"card": card, "layers": 2, "kind": "pfedpara",
           "train_round_s": train_s, "train_record": rec,
           "train_vs_plain": vs_plain,
           "checkpoint_bytes": ckpt_bytes, "leaves_checked": n_leaves,
           "disk_free_before": free_before, "save_s": save_s,
           "restore_s": restore_s, "cache_build_s": build_s,
           "global_precompose_vs_fused_rel_errs": glob_errs,
           "user_rel_errs": user_errs, "launches_train": counts,
           "launches_serve": counts_serve}
    say("checkpoint_serve", **out)
    measurements["checkpoint_serve"] = out
    return {k: counts[k] + counts_serve[k] for k in counts}


# ------------------------------------------------------------ main

def _layer_sums(cases):
    """{kernel: {case: numbers}}: each full-width case summed over one
    layer's 7 projections (wq, wk, wv, wo, gate, up, down), the unit
    of the per-layer numbers in PERF.md; the error is the largest, and
    ``bound_by`` is the side that bounds most of the summed time."""
    out = {}
    for kernel, rows in cases.items():
        if kernel not in SOURCES:    # checks that are not a kernel's cases
            continue
        per = {}
        for row in rows:
            pname, _, _, key = row["case"].split(" ", 3)
            if pname in DISTINCT:
                per.setdefault(key, {})[DISTINCT[pname]] = row
        sums = {}
        for key, by_shape in per.items():
            tot = {k: 0.0 for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms")
                   if k in by_shape[DISTINCT["wq"]]}
            by = {"bytes": 0.0, "operations": 0.0}
            for shape in SHAPES.values():
                row = by_shape[shape]
                for k in tot:   # a kernel with no library call keeps None
                    tot[k] = (None if tot[k] is None or row[k] is None
                              else tot[k] + row[k])
                by[row["bound_by"]] += row["bound_ms"]
            tot["max_abs_err"] = max(r["max_abs_err"]
                                     for r in by_shape.values())
            tot["bound_by"] = max(by, key=by.get)
            sums[key] = tot
        out[kernel] = sums
    return out


def _case(cases, kernel, name):
    """One measured case of a kernel that is not summed per layer."""
    row = next(r for r in cases[kernel] if r["case"] == name)
    return {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err")}


def _summary(sums, launches, cases):
    """One entry per kernel and main-path shape: the numbers of one
    layer's worth of its main-path calls (sums over the layer's
    projections); K8 has its decode and its prefill entry."""
    cl = f"{CLIENTS} clients x {CLIENT_ROWS} rows, bf16"
    plan = [
        ("w8_matmul", "rows=4 int8",
         "one layer's 7 projections, int8 cache, 4 rows (a decode step)"),
        ("w8_matmul", "rows=512 int8",
         "one layer's 7 projections, int8 cache, 512 rows (a prefill of "
         "4 x 128 tokens)"),
        ("fedpara_matmul", "rows=512 fedpara",
         "one layer's 7 projections, 512 rows (prefill)"),
        ("fedpara_dx", "rows=512 fedpara",
         "one layer's 7 projections, 512 rows, bf16"),
        ("fedpara_dfactors", "rows=512 fedpara",
         "one layer's 7 projections, 512 rows, bf16, both sides (2 launches "
         "per projection)"),
        ("cache_residual_matmul", "rows=4 users=4 int8",
         "one layer's 7 projections, 4 users x 1 row (a decode step)"),
        ("fedpara_matmul_clients", f"C={CLIENTS}x{CLIENT_ROWS} fedpara",
         f"one layer's 7 projections, {cl}"),
        ("fedpara_dx_clients", f"C={CLIENTS}x{CLIENT_ROWS} fedpara",
         f"one layer's 7 projections, {cl}"),
        ("fedpara_dfactors_clients", f"C={CLIENTS}x{CLIENT_ROWS} fedpara",
         f"one layer's 7 projections, {cl}, both sides"),
        ("dequant_acc", f"layer C={AGG_CLIENTS} L={AGG_L} fp32",
         f"{AGG_CLIENTS} clients' fp32 (identity-codec) wire over one "
         "qwen3-8b layer's FedPara factors, one launch"),
        ("fedpara_compose", "fp32 fedpara",
         "one layer's 7 projections composed to fp32 W (the int8 cache's "
         "compose), one launch each"),
        ("fedpara_compose_stacked", f"L={MAIN_STACK} fp16 fedpara",
         f"each of one layer's 7 projections stacked over {MAIN_STACK} "
         "layers, composed to fp16 W (phase 4's fp16 cache), one launch "
         "each")]
    out = []
    for kernel, key, at in plan:
        tot = sums[kernel].get(key) or _case(cases, kernel, key)
        out.append({"name": kernel, "route": "cuda",
                    "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                    "launches": launches[kernel],
                    "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                    "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                    "bound_by": tot["bound_by"],
                    "library_ms": tot["library_ms"], "at": at})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at two shapes only")
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import ops  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card, build_info = phase_build()
    clock = Clock(reps=5)
    cases = phase_kernels(clock, args.quick)
    measurements = {"card": card, "build": build_info, "kernels": cases}
    if not args.quick:
        from repro_torch.launch.serve import seeded_params

        del clock
        torch.cuda.empty_cache()
        params = seeded_params(_cfg("fedpara", 36), 0, "cuda")
        launches = {k: 0 for k in ops.KERNELS}
        for phase in (phase_serve, phase_parity):
            for k, v in phase(params, measurements).items():
                launches[k] += v
        del params
        torch.cuda.empty_cache()
        for k, v in phase_users(measurements).items():
            launches[k] += v
        torch.cuda.empty_cache()
        phase_card_vs_host(measurements)
        torch.cuda.empty_cache()
        phase_layer_grad(measurements)
        torch.cuda.empty_cache()
        for phase in (phase_train, phase_engines):
            for k, v in phase(measurements).items():
                launches[k] += v
        torch.cuda.empty_cache()
        for k, v in phase_checkpoint_serve(card, measurements).items():
            launches[k] += v
        missing = [k for k in ops.KERNELS if launches[k] == 0]
        check(not missing, f"kernels never launched on the main path: "
              f"{missing}")
        measurements["layer_sums"] = _layer_sums(cases)
        summary = _summary(measurements["layer_sums"], launches, cases)
        measurements["summary"] = summary
        print(json.dumps({"kernels": summary}), flush=True)
    measurements["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(measurements, indent=1,
                                             default=str))
    say("done", seconds=measurements["seconds"], card=card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
