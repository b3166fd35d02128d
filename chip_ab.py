"""Two trees on one card, in turns: phase 3's and phase 5's serve numbers,
the serve caches' build times and the device times of the compose
kernels K5/K6, K8's decode kernel and K4, every run measured by this
tree's ``chip_smoke.py`` (its phases and its ``Clock``).

Phase 3's decode and phase 5's prefill are host-bound, and their wall
times move from run to run and from machine to machine more than a
kernel change moves them; kernel times depend on how they are taken.
So both trees are measured by one yardstick, in one call. To compare
two commits, unpack the other one into a git-ignored directory of this
repository (``git archive``) and run, from the repository root, on a
machine with one H100:

    python3 chip_ab.py build/parent . --pairs 10

The runs go A, B, B, A, A, B, B, A, ... (``--pairs`` runs of each
tree), each in a process of its own that builds that tree's kernels
from its own sources (``build/`` under the tree, once) and imports that
tree's ``repro_torch``. A run serves 36-layer qwen3-8b at batch 4 (phase
3, whose int8 cache K5 builds; then phase 4's fp16 cache, which K6
builds, on the same weights; then 16 more decode steps, each step's
host enqueue time on the host clock against the steps' span in CUDA
events) and 4 pFedPara users (phase 5), then, unless ``--no-kernels``,
times K5 (one qwen3-8b layer's 7 projections to fp32 W), K6 (each
projection stacked over 36 layers, fp16 W), and
per qwen3-8b layer of 7 projections (L2 flushed): K8 at 4 rows with an
int8 and an fp16 cache; K4, both sides, at 512 rows of bf16 and of fp32
and at 4 clients x 128 rows of bf16; and K4 at the gate projection with
r = 505; K8 at 4 rows (int8) and ``torch.matmul`` on a bf16 W after
a flush that only reads, leaving no dirty lines in the L2; last, the
host time of one K8 call at 4 rows (the fastest of
3 rounds of 280 calls), behind a device-side spin (the card busy) and
without (the card idle), and its device time behind a spin, back to
back and interleaved with a small PyTorch kernel (with that kernel's
own time). One JSON line per run, then the card's name and power limit;
exits non-zero without a card or when a run fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = """
import importlib.util, json, sys, time
from pathlib import Path
tree, here, kernels = Path(sys.argv[1]).resolve(), Path(sys.argv[2]), sys.argv[3] == "1"
sys.path.insert(0, str(tree / "src"))
spec = importlib.util.spec_from_file_location("ab_smoke", here / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
sys.modules["ab_smoke"] = cs
spec.loader.exec_module(cs)
import torch
from repro_torch.kernels import build, ops
from repro_torch.launch.serve import seeded_params
from repro_torch.nn.layers import quantize_int8
assert Path(ops.__file__).resolve().is_relative_to(tree), ops.__file__
build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
m = {}
cfg = cs._cfg("fedpara", 36)
params = seeded_params(cfg, 0, "cuda")
cs.phase_serve(params, m)
# phase 4's fp16 cache (K6, one launch per projection kind), built as
# phase_parity builds it, on the same weights
from repro_torch.nn.transformer import ModelOptions
from repro_torch.serve import ServeEngine
torch.cuda.synchronize()
t0 = time.perf_counter()
eng16 = ServeEngine(cfg, params, mode="precompose", cache_dtype="fp16", batch=4,
                    opts=ModelOptions(attn_chunk=64, dtype=torch.float32))
torch.cuda.synchronize()
fp16_build_s = time.perf_counter() - t0
del eng16
torch.cuda.empty_cache()
# decode's host time per step (the enqueue, no sync) against its span on
# the card (CUDA events around 16 steps), on a fresh int8 engine
eng = ServeEngine(cfg, params, mode="precompose", cache_dtype="int8", batch=4)
prompts = torch.as_tensor(cs._prompts(4, 128, cfg.vocab_size, 1), device="cuda")
cache = eng.init_cache(4, 128 + 18)
cache, logits = eng.prefill(prompts, cache)
tok = torch.argmax(logits, -1)[:, None]
logits, cache = eng.decode_step(cache, tok, 128)
torch.cuda.synchronize()
host = []
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for i in range(1, 17):
    t0 = time.perf_counter()
    logits, cache = eng.decode_step(cache, tok, 128 + i)
    tok = torch.argmax(logits, -1)[:, None]
    host.append(time.perf_counter() - t0)
b.record()
torch.cuda.synchronize()
decode_host = {"decode_host_ms_per_step": sorted(host)[8] * 1e3,
               "decode_host_ms_total": sum(host) * 1e3,
               "decode_events_ms": a.elapsed_time(b)}
del eng, cache, logits, params
torch.cuda.empty_cache()
cs.phase_users(m)
s, p = m["serve"], m["serve"]["decode_profile"]
row = {"tree": sys.argv[1], "prefill_ms": s["prefill_ms"],
       "decode_ms": s["decode_ms"],
       "decode_busy_share": p.get("device_busy_share"),
       "decode_device_us_2_steps": p.get("device_us"),
       "users_prefill_ms": m["users"]["prefill_ms"],
       "users_decode_ms": m["users"]["decode_ms"],
       "int8_cache_build_s": s["build_s"], "fp16_cache_build_s": fp16_build_s,
       **decode_host}
if kernels:
    torch.cuda.empty_cache()
    clock = cs.Clock(reps=5)
    gen = torch.Generator(device="cuda").manual_seed(7)
    # K5: one layer's 7 projections to fp32 W (phase 3's int8 cache);
    # K6: each projection stacked over 36 layers to fp16 W (phase 4's)
    k5 = k6 = 0.0
    for mm, n, r in cs.SHAPES.values():
        fac = cs._factors(gen, mm, n, r)
        k5 += clock(lambda: ops.fedpara_compose(*fac, out_dtype=torch.float32))
        stack = tuple(torch.stack([f] * cs.MAIN_STACK) for f in fac)
        k6 += clock(lambda: ops.fedpara_compose(*stack, out_dtype=torch.float16))
        del fac, stack
        torch.cuda.empty_cache()
    row.update(compose_fp32_layer_ms=k5, compose_stacked_fp16_36_ms=k6)
    # the Clock's flush writes 256 MB, so the L2 holds dirty lines whose
    # write-back shares DRAM with the timed reads; this one reads them
    # (a sum), leaving the L2 clean, to size that share for K8 at decode
    def read_flush_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            clock.flush_buf.view(torch.int64).sum()
            torch.cuda._sleep(clock.HEAD_CYCLES)
            ea = torch.cuda.Event(enable_timing=True)
            eb = torch.cuda.Event(enable_timing=True)
            ea.record()
            fn()
            eb.record()
            evs.append((ea, eb))
        torch.cuda.synchronize()
        return sorted(ea.elapsed_time(eb) for ea, eb in evs)[reps // 2]
    k = {"w8_decode_int8_ms": 0.0, "w8_decode_fp16_ms": 0.0,
         "w8_decode_int8_ms_read_flush": 0.0, "matmul_bf16_4_ms_read_flush": 0.0,
         "dfactors_bf16_512_ms": 0.0, "dfactors_fp32_512_ms": 0.0,
         "dfactors_clients_ms": 0.0}
    both = lambda x, dy, fac: cs._both_sides(ops.fedpara_dfactors, x, dy, fac, "fedpara")
    for name, (mm, n, r) in cs.SHAPES.items():
        q = quantize_int8(torch.randn((mm, n), generator=gen, device="cuda"))
        w16 = torch.randn((mm, n), generator=gen, device="cuda").half()
        x4 = torch.randn((4, mm), generator=gen, device="cuda").to(torch.bfloat16)
        k["w8_decode_int8_ms"] += clock(lambda: ops.w8_matmul(x4, q["w_q"], q["scale"]))
        k["w8_decode_fp16_ms"] += clock(lambda: ops.w8_matmul(x4, w16))
        k["w8_decode_int8_ms_read_flush"] += read_flush_ms(
            lambda: ops.w8_matmul(x4, q["w_q"], q["scale"]))
        wb = w16.to(torch.bfloat16)
        k["matmul_bf16_4_ms_read_flush"] += read_flush_ms(lambda: torch.matmul(x4, wb))
        del q, w16, wb
        fac = cs._factors(gen, mm, n, r)
        for dt, key in ((torch.bfloat16, "dfactors_bf16_512_ms"),
                        (torch.float32, "dfactors_fp32_512_ms")):
            x = torch.randn((512, mm), generator=gen, device="cuda").to(dt)
            dy = torch.randn((512, n), generator=gen, device="cuda").to(dt)
            k[key] += clock(lambda: both(x, dy, fac))
        cfac = cs._client_factors(gen, cs.CLIENTS, mm, n, r)
        x = torch.randn((cs.CLIENTS, cs.CLIENT_ROWS, mm), generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn((cs.CLIENTS, cs.CLIENT_ROWS, n), generator=gen,
                         device="cuda").to(torch.bfloat16)
        k["dfactors_clients_ms"] += clock(lambda: both(x, dy, cfac))
        del fac, cfac, x, dy
    mm, n, _ = cs.SHAPES["w_gate"]
    fac = cs._factors(gen, mm, n, 505)
    x = torch.randn((512, mm), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((512, n), generator=gen, device="cuda").to(torch.bfloat16)
    k["dfactors_gate_r505_bf16_512_ms"] = clock(lambda: both(x, dy, fac))
    del fac, x, dy
    # host time of one K8 call at decode (the 7 projections in turn, 40
    # layers' worth): with the card busy (a spin queued first, so the
    # launches only queue) and with the card idle (each launch finds it
    # idle: the device is faster than the host)
    qs = []
    for mm, n, _ in cs.SHAPES.values():
        q = quantize_int8(torch.randn((mm, n), generator=gen, device="cuda"))
        qs.append((torch.randn((4, mm), generator=gen, device="cuda")
                   .to(torch.bfloat16), q["w_q"], q["scale"]))
    def host_us(busy):
        for x4, wq, sc in qs:
            ops.w8_matmul(x4, wq, sc)
        torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(400_000_000)
        t0 = time.perf_counter()
        for _ in range(40):
            for x4, wq, sc in qs:
                ops.w8_matmul(x4, wq, sc)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / (40 * len(qs)) * 1e6
    k["w8_decode_host_us_busy"] = min(host_us(True) for _ in range(3))
    k["w8_decode_host_us_idle"] = min(host_us(False) for _ in range(3))
    # device time of one K8 call at decode with the launches queued ahead
    # (a spin first; no L2 flush): back to back, and each followed by a
    # small PyTorch kernel, as decode interleaves them
    small = torch.zeros(4 * 4096, device="cuda")
    def device_us(interleave):
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(40):
            for x4, wq, sc in qs:
                ops.w8_matmul(x4, wq, sc)
                if interleave:
                    small.mul_(0.5)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) * 1e3 / (40 * len(qs))
    k["w8_decode_device_us_back_to_back"] = min(device_us(False) for _ in range(3))
    k["w8_decode_device_us_interleaved"] = min(device_us(True) for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(40 * len(qs)):
        small.mul_(0.5)
    b.record()
    torch.cuda.synchronize()
    k["small_kernel_device_us"] = a.elapsed_time(b) * 1e3 / (40 * len(qs))
    row.update(k)
print(json.dumps(row))
"""


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--pairs", type=int, default=2,
                    help="runs of each tree (order A, B, B, A, ...)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="the serve phases only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    a, b = args.tree_a, args.tree_b
    for tree in (a, b):
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            print(f"chip_ab: {tree} holds no repro_torch", file=sys.stderr)
            return 2
    order = [(a, b) if i % 2 == 0 else (b, a) for i in range(args.pairs)]
    for tree in [t for pair in order for t in pair]:
        out = subprocess.run(
            [sys.executable, "-c", _RUN, tree, str(here),
             "0" if args.no_kernels else "1"],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
