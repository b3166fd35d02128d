"""Per-layer precompose-vs-fused decision model for the serve engine.

For each factorized layer (m, n, r) at a given decode batch B, two
weight layouts compete:

precompose
    W composed once at load time and cached — int8 with per-channel
    scales (mn bytes/step) or fp16 (2mn bytes/step), both read by the
    K8 kernel (``ops.w8_matmul``). Step FLOPs are the dense 2Bmn.

fused
    Only factors live in device memory. Two implementations: the tile
    kernel K1 (compose tiles on chip; ~4mnr compose FLOPs per slab of
    rows) and the Hadamard-Gram identity (O(r²(m+n)) FLOPs per token,
    no (m, n) object anywhere). The cost model picks the cheaper one.

Costs are rooflines — time = max(bytes/BW, flops/peak) — keyed on
(m, n, r, batch), where the rank-r compose and the Gram contractions
(fp32 factors, CUDA cores) are priced at the fp32 rate and the
activation contraction at the bf16 tensor-core rate; with optional
direct measurement on the card
(CUDA events, median of k runs of the exact op each mode runs).
``auto`` takes the measured branch when measurements exist, the
analytic one otherwise. The byte and FLOP counts are the reference's
(``repro/serve/cost_model.py``); the roofline constants are the H100's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

# Roofline constants of an NVIDIA H100 SXM5 80 GB at its 700 W power
# limit (NVIDIA data sheet, dense rates): 3.35 TB/s HBM3, 989 bf16
# TFLOP/s on the tensor cores and 67 fp32 TFLOP/s outside them. A card
# set below 700 W runs slower under load; only the ratios matter for
# ranking the modes. ``chip_smoke.py`` states its kernel bounds with
# the same constants.
H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_FP32_TFLOPS = 67.0
H100_TF32_TFLOPS = 495.0   # tensor cores, dense (chip_smoke.py prices 3xTF32 at a third)

MODES = ("precompose", "fused")


def predict_us(bytes_: float, flops: float, fp32_flops: float = 0.0, *,
               hbm_gbps: float = H100_HBM_GBPS,
               peak_tflops: float = H100_BF16_TFLOPS,
               fp32_tflops: float = H100_FP32_TFLOPS) -> float:
    """Roofline latency (µs) for a step moving ``bytes_`` and doing
    ``flops``, of which ``fp32_flops`` run at the fp32 rate and the rest
    at the bf16 peak."""
    ops_us = ((flops - fp32_flops) / (peak_tflops * 1e6)
              + fp32_flops / (fp32_tflops * 1e6))
    return max(bytes_ / (hbm_gbps * 1e3), ops_us)


def mode_costs(m: int, n: int, r: int, batch: int, *, kind: str = "fedpara",
               weight_dtype: str = "int8", users: int = 0,
               block_b: int = 64) -> Dict[str, Dict[str, Any]]:
    """{mode: {bytes, flops, fp32_flops, impl}} for one layer at one
    decode batch. ``fp32_flops`` is the part of ``flops`` done on the
    fp32 factors (compose, residual, Gram); the rest is the contraction
    with the bf16 activations.

    ``users`` > 0 marks a personalized pFedPara layer serving that many
    distinct users per step (batch rows are user rows).
    """
    act = 2.0 * batch * (m + n)  # bf16 activations in + out
    wbytes = m * n * (1 if weight_dtype == "int8" else 2) + 4 * n
    fbytes = 4.0 * 4 * r * (m + n)  # four fp32 factor panels
    out: Dict[str, Dict[str, Any]] = {}
    if users > 0 and kind == "pfedpara":
        ufac = 2.0 * 4 * r * (m + n) * users  # gathered (X2, Y2) slices
        resid = users * (2.0 * m * n * (r + 1))
        out["precompose"] = {
            "bytes": users * wbytes + ufac + act,
            "flops": resid + 2.0 * batch * m * n,
            "fp32_flops": resid,
            "impl": "cache_residual",
        }
        gram = 2.0 * batch * (r * r + r) * (m + n)
        out["fused"] = {
            "bytes": fbytes + ufac + 8.0 * batch * r * (m + n),
            "flops": gram,
            "fp32_flops": gram,
            "impl": "gram",
        }
        return out
    out["precompose"] = {
        "bytes": wbytes + act,
        "flops": 2.0 * batch * m * n,
        "fp32_flops": 0.0,
        "impl": "w8" if weight_dtype == "int8" else "w16",
    }
    slabs = -(-batch // block_b)
    compose = slabs * 4.0 * m * n * r
    tile = {
        "bytes": fbytes * slabs + act,
        "flops": compose + 2.0 * batch * m * n,
        "fp32_flops": compose,
        "impl": "tile",
    }
    if kind == "fedpara_tanh":
        out["fused"] = tile
        return out
    gflops = (2.0 * batch * r * r * (m + n)
              + (2.0 * batch * r * (m + n) if kind == "pfedpara" else 0.0))
    gram = {
        "bytes": fbytes + 8.0 * batch * r * (m + n) + act,
        "flops": gflops,
        "fp32_flops": gflops,
        "impl": "gram",
    }
    out["fused"] = min((gram, tile), key=lambda c: predict_us(**_bf(c)))
    return out


def _bf(c):
    return {"bytes_": c["bytes"], "flops": c["flops"],
            "fp32_flops": c["fp32_flops"]}


def crossover_batch(m: int, n: int, r: int, *, kind: str = "fedpara",
                    weight_dtype: str = "int8", max_batch: int = 4096) -> int:
    """Smallest batch where precompose's roofline beats fused (doubling
    scan; ``max_batch`` when fused wins everywhere)."""
    b = 1
    while b <= max_batch:
        c = mode_costs(m, n, r, b, kind=kind, weight_dtype=weight_dtype)
        if predict_us(**_bf(c["precompose"])) < predict_us(**_bf(c["fused"])):
            return b
        b *= 2
    return max_batch


# ------------------------------------------------------------- measurement

def _median_time_us(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warmup."""
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def measure_modes(m: int, n: int, r: int, batch: int, *,
                  kind: str = "fedpara", weight_dtype: str = "int8",
                  users: int = 0, dtype=torch.bfloat16, reps: int = 5,
                  device="cuda") -> Dict[str, float]:
    """Measured µs per mode on the card: the exact single-layer op each
    serving mode would run, on random factors, median of ``reps``."""
    from repro_torch.kernels import ops
    from repro_torch.nn.layers import quantize_int8

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_modes times the card; it needs a CUDA "
                           "device")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.1

    x1, y1, x2, y2 = rnd(m, r), rnd(n, r), rnd(m, r), rnd(n, r)
    costs = mode_costs(m, n, r, batch, kind=kind, weight_dtype=weight_dtype,
                       users=users)
    out: Dict[str, float] = {}
    if users > 0 and kind == "pfedpara":
        w1 = x1 @ y1.T
        node = quantize_int8(w1) if weight_dtype == "int8" else {
            "w": w1.half()}
        w, s = node.get("w_q", node.get("w")), node.get("scale")
        t = max(1, batch // users)
        xs = rnd(users, t, m).to(dtype)
        ux2 = x2.expand(users, m, r).contiguous()
        uy2 = y2.expand(users, n, r).contiguous()
        out["precompose"] = _median_time_us(
            lambda: ops.cache_residual_matmul(xs, w, s, ux2, uy2), reps)
        out["fused"] = _median_time_us(
            lambda: ops.fedpara_gram_decode(xs, x1, y1, ux2, uy2,
                                            kind="pfedpara"), reps)
        return out

    xs = rnd(batch, m).to(dtype)
    wd = ops.fedpara_compose(x1, y1, x2, y2, kind=kind,
                             out_dtype=torch.float32)
    node = quantize_int8(wd) if weight_dtype == "int8" else {"w": wd.half()}
    w, s = node.get("w_q", node.get("w")), node.get("scale")
    out["precompose"] = _median_time_us(lambda: ops.w8_matmul(xs, w, s), reps)
    if costs["fused"]["impl"] == "gram":
        out["fused"] = _median_time_us(
            lambda: ops.fedpara_gram_decode(xs, x1, y1, x2, y2, kind=kind),
            reps)
    else:
        out["fused"] = _median_time_us(
            lambda: ops.fedpara_matmul(xs, x1, y1, x2, y2, kind=kind), reps)
    return out


# ---------------------------------------------------------------- planning

@dataclass
class LayerDecision:
    """One layer's serving decision (a decision-table row)."""

    path: str
    m: int
    n: int
    r: int
    kind: str
    mode: str            # precompose | fused | dense (unfactorized)
    impl: str            # w8 | w16 | gram | tile | cache_residual | einsum
    weight_dtype: str
    predicted_us: Dict[str, float] = field(default_factory=dict)
    measured_us: Dict[str, float] = field(default_factory=dict)
    crossover_batch: int = 0

    def as_row(self) -> Dict[str, Any]:
        """JSON-ready dict of this decision."""
        return {
            "path": self.path, "m": self.m, "n": self.n, "r": self.r,
            "kind": self.kind, "mode": self.mode, "impl": self.impl,
            "weight_dtype": self.weight_dtype,
            "predicted_us": self.predicted_us,
            "measured_us": self.measured_us,
            "crossover_batch": self.crossover_batch,
        }


def decide(path: str, m: int, n: int, r: int, *, batch: int,
           kind: str = "fedpara", mode: str = "auto",
           weight_dtype: str = "int8", users: int = 0,
           measured: Optional[Dict[str, float]] = None) -> LayerDecision:
    """Resolve one layer's mode. ``mode`` precompose/fused forces the
    layout; ``auto`` ranks by ``measured`` µs when given, else by the
    analytic roofline."""
    costs = mode_costs(m, n, r, batch, kind=kind, weight_dtype=weight_dtype,
                       users=users)
    predicted = {md: predict_us(**_bf(c)) for md, c in costs.items()}
    measured = dict(measured or {})
    if mode in MODES:
        chosen = mode
    else:
        ranking = measured or predicted
        chosen = min(ranking, key=ranking.get)
    return LayerDecision(
        path=path, m=m, n=n, r=r, kind=kind, mode=chosen,
        impl=costs[chosen]["impl"], weight_dtype=weight_dtype,
        predicted_us=predicted, measured_us=measured,
        crossover_batch=crossover_batch(m, n, r, kind=kind,
                                        weight_dtype=weight_dtype),
    )


def _node_spec(node) -> Optional[Dict[str, Any]]:
    """(m, n, r) of a factor node, tolerating layer-stacked (L, ...)
    leaves."""
    from repro_torch.core import parameterization as par

    if not isinstance(node, dict) or "x1" not in node or "y1" not in node:
        return None
    probe = node
    if getattr(node["x1"], "ndim", 0) == 3:
        probe = {k: v[0] for k, v in node.items()}
    return par.factor_spec(probe)


def plan_params(params: Any, kind: str, *, batch: int, mode: str = "auto",
                weight_dtype: str = "int8", users: int = 0,
                measure: bool = False, device="cuda"
                ) -> Dict[str, LayerDecision]:
    """Walk a params tree and produce {path: LayerDecision} for every
    matrix factor node (dense {'w'} nodes become mode 'dense' rows).
    ``measure`` times each distinct (m, n, r) once on the card."""
    plan: Dict[str, LayerDecision] = {}
    timings: Dict[tuple, Dict[str, float]] = {}
    u = users if kind == "pfedpara" else 0

    def walk(node, path):
        spec = _node_spec(node)
        if spec is not None and spec.get("kind") == "matrix":
            m, n, r = spec["m"], spec["n"], spec["r"]
            if measure and (m, n, r) not in timings:
                timings[(m, n, r)] = measure_modes(
                    m, n, r, batch, kind=kind, weight_dtype=weight_dtype,
                    users=u, device=device)
            plan[path] = decide(path, m, n, r, batch=batch, kind=kind,
                                mode=mode, weight_dtype=weight_dtype,
                                users=u, measured=timings.get((m, n, r)))
            return
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) >= 2:
                plan[path] = LayerDecision(
                    path=path, m=int(node["w"].shape[-2]),
                    n=int(node["w"].shape[-1]), r=0, kind=kind,
                    mode="dense", impl="einsum", weight_dtype="native")
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))

    walk(params, "")
    return plan


def decision_table(plan: Dict[str, LayerDecision]) -> List[Dict[str, Any]]:
    """JSON-ready decision-table rows, sorted by path."""
    return [plan[p].as_row() for p in sorted(plan)]
