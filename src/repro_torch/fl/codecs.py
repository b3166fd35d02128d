"""Composable up/down-link codecs of the FL wire (PyTorch), the
counterpart of the reference's ``repro/fl/codecs.py``.

A codec is a pipeline of stages selected by a spec string, e.g.
``"delta|topk0.1|int8"``:

  delta        encode the payload as a difference against a reference
               tree (the last decoded broadcast for the downlink, the
               round's decoded broadcast for the uplink).
  topk{f}      per-leaf magnitude top-k keeping a fraction ``f`` of the
               entries, with an error-feedback accumulator: the
               discarded residual is added back into the next round's
               input.
  lowrank{r}   SVD-truncate each eligible 2-D leaf of the update to rank
               ``r`` (integer) or ``round(r * min_dim)`` when ``r`` < 1;
               the wire carries the two factors.
  int8 / fp16  the quantizers of ``repro_torch.fl.comm`` (per-tensor
               symmetric int8 with stochastic rounding / fp16 cast).

Stage order is canonical and validated as the reference's: ``delta``
first, then at most one of ``topk``/``lowrank``, then at most one
quantizer; ``""``, ``"fp32"``, ``"none"`` and ``"identity"`` name the
identity codec. :func:`make_codec` raises the reference's errors.

Differences from the reference, each by design:

* **Top-k is exact on every device**: ``torch.topk`` of ``|x|`` over
  each (client's) flattened leaf, scattered into a zero carrier. The
  reference takes ``jax.lax.approx_max_k`` on accelerators; torch has no
  such function, so the card and the host keep the same entries.
* The int8 stage takes its rounding noise as ``noise=`` where the
  reference takes ``key=``: a callable that maps the int8 stage's input
  to its noise, a tree shaped like that input holding U[-0.5, 0.5) in
  each leaf's dtype (the server's per-position draws). A codec with an
  int8 stage raises without it.
* Every method that touches data takes ``stacked=True`` for a
  client-stacked payload (every leaf leads with the client axis C, the
  reference tree does not; one int8 scale and one top-k selection per
  client): the reference's ``vmap`` written out.

The in-memory wire tree is value-faithful: top-k keeps a dense masked
carrier, low-rank carries ``{"lr_u", "lr_v"}`` factor nodes and int8
``{"q", "scale"}`` nodes. Byte accounting is exact and
data-independent: :meth:`Codec.wire_bytes` replays the stage algebra
over the payload's leaf shapes, :func:`measured_bytes` walks an encoded
wire tree, and both give the reference's integers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.fl import comm
from repro_torch.fl.strategies import tree_sub, tree_zeros
from repro_torch.tree import tree_leaves, tree_map

_IDENTITY_SPECS = ("", "fp32", "none", "identity")
_LR_KEYS = frozenset(("lr_u", "lr_v"))

# stage kind -> pipeline category (must be strictly increasing in a spec)
_CATEGORY = {"delta": 0, "topk": 1, "lowrank": 1, "int8": 2, "fp16": 2}


@dataclass(frozen=True)
class Stage:
    kind: str                 # delta | topk | lowrank | int8 | fp16
    param: float = 0.0        # topk fraction / lowrank rank


def _topk_count(shape, frac: float) -> int:
    n = math.prod(int(d) for d in shape) if shape else 1
    return max(1, min(n, int(math.ceil(frac * n))))


def _lowrank_rank(shape, param: float) -> int:
    m, n = int(shape[0]), int(shape[1])
    return int(param) if param >= 1 else max(1, int(round(param * min(m, n))))


def _lowrank_eligible(shape, param: float) -> bool:
    if len(shape) != 2:
        return False
    m, n = int(shape[0]), int(shape[1])
    r = _lowrank_rank(shape, param)
    return r < min(m, n) and r * (m + n) < m * n


def _is_lr_node(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == _LR_KEYS


def _item_shape(x: torch.Tensor, stacked: bool) -> tuple:
    """One client's leaf shape (the client axis dropped when stacked)."""
    return tuple(x.shape[1:] if stacked else x.shape)


# ----------------------------------------------------------- stage encoders

def _topk_leaf(x: torch.Tensor, frac: float, stacked: bool) -> torch.Tensor:
    """Dense masked carrier: the k largest |entries| of each client's
    flattened leaf kept, the rest zeroed (exact selection)."""
    k = _topk_count(_item_shape(x, stacked), frac)
    flat = x.reshape(x.shape[0], -1) if stacked else x.reshape(-1)
    idx = torch.topk(flat.abs(), k, dim=-1, sorted=False).indices
    kept = torch.zeros_like(flat).scatter_(-1, idx, flat.gather(-1, idx))
    return kept.reshape(x.shape)


def _lowrank_encode_leaf(x: torch.Tensor, param: float, stacked: bool) -> Any:
    shape = _item_shape(x, stacked)
    if not _lowrank_eligible(shape, param):
        return x
    r = _lowrank_rank(shape, param)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    return {"lr_u": u[..., :r] * s[..., None, :r], "lr_v": vt[..., :r, :]}


def _lowrank_decode(tree: Any) -> Any:
    def walk(n):
        if _is_lr_node(n):
            return torch.matmul(n["lr_u"], n["lr_v"])
        if isinstance(n, dict):
            return {k: walk(v) for k, v in n.items()}
        if isinstance(n, (list, tuple)):
            return type(n)(walk(v) for v in n)
        return n

    return walk(tree)


# ------------------------------------------------------------------- codec

@dataclass(frozen=True)
class Codec:
    spec: str
    stages: Tuple[Stage, ...] = ()

    @property
    def is_identity(self) -> bool:
        return not self.stages

    @property
    def has_ef(self) -> bool:
        """Whether the codec keeps error feedback (top-k only)."""
        return any(s.kind == "topk" for s in self.stages)

    @property
    def has_delta(self) -> bool:
        """Whether the codec sends differences against a reference."""
        return any(s.kind == "delta" for s in self.stages)

    def ef_init(self, payload: Any) -> Optional[Any]:
        """Zero error-feedback accumulator (payload structure), or None.
        It is per-client state: the server keeps it under
        ``client_states[cid]["_ef_up"]`` (stacked in the batched and
        streaming engines' client state)."""
        return tree_zeros(payload) if self.has_ef else None

    def ef_nbytes(self, payload: Any) -> int:
        """Bytes one client's error-feedback accumulator occupies (0
        when the codec keeps none)."""
        if not self.has_ef:
            return 0
        return int(sum(x.numel() * x.element_size()
                       for x in tree_leaves(payload)))

    # -------------------------------------------------------------- encode
    def encode(self, payload: Any, *, ref: Any = None, ef: Any = None,
               noise: Any = None, stacked: bool = False
               ) -> Tuple[Any, Optional[Any]]:
        """Returns ``(wire, new_ef)``. ``ref`` is one unstacked tree
        (broadcast over the clients when ``stacked``); ``ef`` and
        ``payload`` are stacked alike; ``noise`` feeds the int8 stage
        (module docstring)."""
        x = payload
        new_ef = ef
        for st in self.stages:
            if st.kind == "delta":
                if ref is None:
                    raise ValueError("delta stage requires a reference tree")
                x = tree_sub(x, ref)
            elif st.kind == "topk":
                if ef is not None:
                    x = tree_map(lambda a, e: a + e, x, ef)
                kept = tree_map(lambda a: _topk_leaf(a, st.param, stacked), x)
                new_ef = tree_sub(x, kept)
                x = kept
            elif st.kind == "lowrank":
                x = tree_map(
                    lambda a: _lowrank_encode_leaf(a, st.param, stacked), x)
            elif st.kind == "fp16":
                x = comm.quantize_fp16(x)
            elif st.kind == "int8":
                if not callable(noise):
                    raise ValueError("int8 stage requires a noise source "
                                     "(a callable of the stage's input)")
                x = comm.quantize_int8(x, noise(x), stacked)
        return x, new_ef

    def decode(self, wire: Any, *, ref: Any = None) -> Any:
        """Invert :meth:`encode`: map a wire tree (stacked or not) back
        to payload space; ``ref`` is required iff the spec has
        ``delta``. Top-k carriers are dense, so that stage decodes as
        the identity."""
        x = wire
        for st in reversed(self.stages):
            if st.kind == "int8":
                x = comm.dequantize_int8(x)
            elif st.kind == "fp16":
                x = comm.dequantize_fp16(x)
            elif st.kind == "lowrank":
                x = _lowrank_decode(x)
            elif st.kind == "delta":
                if ref is None:
                    raise ValueError("delta stage requires a reference tree")
                x = tree_map(lambda d, r: d + r, x, ref)
        return x

    def encode_decode(self, payload: Any, *, ref: Any = None, ef: Any = None,
                      noise: Any = None, stacked: bool = False
                      ) -> Tuple[Any, Optional[Any]]:
        """One simulated wire round trip: ``(decoded, new_ef)``."""
        if self.is_identity:
            return payload, ef
        wire, new_ef = self.encode(payload, ref=ref, ef=ef, noise=noise,
                                   stacked=stacked)
        return self.decode(wire, ref=ref), new_ef

    # ------------------------------------------- encoded-form aggregation
    #
    # The streaming engine folds Σ_c w_c · dequant(wire_c) straight into
    # an fp32 accumulator (K7). That needs the remaining decode to be
    # linear per leaf: int8 dequant, fp16 widening and the top-k carrier
    # are; the low-rank product is not, and the delta reference is a
    # constant the mean absorbs: mean(decode(wire_c)) = mean(lin) + ref.

    @property
    def agg_linear(self) -> bool:
        """True when decode(wire) = linear-dequant(wire) [+ delta ref]
        leaf-wise (no low-rank stage)."""
        return not any(s.kind == "lowrank" for s in self.stages)

    def encode_for_agg(self, payload: Any, *, ref: Any = None, ef: Any = None,
                       noise: Any = None, stacked: bool = False
                       ) -> Tuple[Any, Optional[Any]]:
        """Encode for the encoded-form aggregator: ``(agg_wire, new_ef)``
        with ``decode(wire) = linear(agg_wire) + (ref if has_delta)``.
        ``agg_wire`` leaves are ``{"q", "scale"}`` nodes or dense
        tensors; a low-rank stage is composed back per client here
        (every non-delta stage decoded), the delta offset left to
        :meth:`agg_finalize`."""
        if self.is_identity:
            return payload, ef
        wire, new_ef = self.encode(payload, ref=ref, ef=ef, noise=noise,
                                   stacked=stacked)
        if not self.agg_linear:
            stripped = Codec(spec=self.spec, stages=tuple(
                s for s in self.stages if s.kind != "delta"))
            wire = stripped.decode(wire)
        return wire, new_ef

    def agg_finalize(self, mean: Any, *, ref: Any = None) -> Any:
        """Map the weighted mean of :meth:`encode_for_agg` wires back to
        payload space (adds the delta reference back in)."""
        if self.has_delta:
            if ref is None:
                raise ValueError("delta stage requires a reference tree")
            return tree_map(lambda d, r: d + r.to(d.dtype), mean, ref)
        return mean

    @staticmethod
    def agg_finalize_pinned(mean: Any, refs: Dict[int, Any],
                            coefs: Dict[int, float]) -> Any:
        """Multi-reference :meth:`agg_finalize` for folds whose arrivals
        decode against different pinned broadcasts: adds
        ``sum_d coefs[d] * refs[d]`` over the dispatch ids ``d`` in
        sorted order (a coefficient of 0 adds nothing); with one live
        dispatch at coefficient 1.0 it equals :meth:`agg_finalize`."""
        out = mean
        for d in sorted(coefs):
            c = float(coefs[d])
            if c == 0.0:
                continue
            out = tree_map(
                lambda a, r: a + torch.tensor(c, dtype=torch.float32,
                                              device=a.device) * r.to(a.dtype),
                out, refs[d])
        return out

    # ---------------------------------------------------------- accounting
    def wire_bytes(self, payload: Any) -> int:
        """Exact wire size of one (unstacked) ``payload`` under this
        codec, from leaf shapes alone: per leaf a list of value chunks
        ``(count, bytes_per_value)`` plus index/scale overhead."""
        total = 0
        for leaf in tree_leaves(payload):
            if not isinstance(leaf, torch.Tensor):
                continue
            shape = tuple(int(d) for d in leaf.shape)
            chunks: List[Tuple[int, int]] = [
                (math.prod(shape) if shape else 1, leaf.element_size())]
            overhead = 0
            for st in self.stages:
                if st.kind == "topk":
                    k = _topk_count(shape, st.param)
                    chunks = [(k, bpv) for _, bpv in chunks]
                    overhead += 4 * k                     # int32 indices
                elif st.kind == "lowrank":
                    if _lowrank_eligible(shape, st.param):
                        r = _lowrank_rank(shape, st.param)
                        bpv = chunks[0][1]
                        chunks = [(r * shape[0], bpv), (r * shape[1], bpv)]
                elif st.kind == "fp16":
                    chunks = [(c, 2) for c, _ in chunks]
                elif st.kind == "int8":
                    chunks = [(c, 1) for c, _ in chunks]
                    overhead += 4 * len(chunks)           # per-tensor scales
            total += sum(c * b for c, b in chunks) + overhead
        return int(total)


def measured_bytes(wire: Any, *, topk_frac: Optional[float] = None) -> int:
    """Bytes of an encoded (unstacked) wire tree, by inspection:
    ``{"q", "scale"}`` nodes at stored itemsize + 4 bytes a scale,
    ``{"lr_u", "lr_v"}`` nodes recursed, dense leaves at size x
    itemsize; with ``topk_frac`` a carrier is priced at its k values
    plus 4-byte indices. Agrees with :meth:`Codec.wire_bytes`."""
    def count(t: torch.Tensor) -> int:
        if topk_frac is not None:
            return _topk_count(tuple(t.shape), topk_frac)
        return t.numel()

    def walk(n) -> int:
        if comm._is_qnode(n):
            q, s = n["q"], n["scale"]
            nq = count(q)
            return (nq * q.element_size()
                    + (4 * nq if topk_frac is not None else 0)
                    + 4 * max(s.numel(), 1))
        if _is_lr_node(n):
            return walk(n["lr_u"]) + walk(n["lr_v"])
        if isinstance(n, dict):
            return sum(walk(v) for v in n.values())
        if isinstance(n, (list, tuple)):
            return sum(walk(v) for v in n)
        if isinstance(n, torch.Tensor):
            nv = count(n)
            return nv * n.element_size() + (4 * nv if topk_frac is not None
                                            else 0)
        return 0

    return int(walk(wire))


# ------------------------------------------------------------------ parser

def make_codec(spec: Optional[str]) -> Codec:
    """Parse a codec spec like ``"delta|topk0.1|int8"``."""
    raw = (spec or "").strip()
    if raw in _IDENTITY_SPECS:
        return Codec(spec="fp32")
    stages: List[Stage] = []
    last_cat = -1
    for tok in raw.split("|"):
        tok = tok.strip()
        if tok in ("", "fp32"):
            continue
        if tok == "delta":
            st = Stage("delta")
        elif tok.startswith("topk"):
            frac = float(tok[len("topk"):])
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"topk fraction must be in (0, 1]: {tok!r}")
            st = Stage("topk", frac)
        elif tok.startswith("lowrank"):
            val = float(tok[len("lowrank"):])
            if val <= 0:
                raise ValueError(f"lowrank rank must be positive: {tok!r}")
            st = Stage("lowrank", val)
        elif tok in ("int8", "fp16"):
            st = Stage(tok)
        else:
            raise ValueError(
                f"unknown codec stage {tok!r} in {raw!r} "
                "(expected delta | topk<f> | lowrank<r> | int8 | fp16)")
        cat = _CATEGORY[st.kind]
        if cat <= last_cat:
            raise ValueError(
                f"codec {raw!r}: stages must follow delta -> "
                "topk|lowrank -> int8|fp16, each at most once "
                "(topk and lowrank are mutually exclusive)")
        last_cat = cat
        stages.append(st)
    return Codec(spec=raw, stages=tuple(stages))
