"""Payload selection, quantization and byte accounting on the FL wire
(PyTorch), the counterpart of the reference's ``repro/fl/comm.py``: the
pFedPara split and merge (paper §2.3: only the global half x1/y1
travels), the FedPAQ-style quantizers (fp16 cast; per-tensor symmetric
int8 with stochastic rounding) and :class:`CommLog`.

The int8 quantizer takes its rounding noise as an argument: a tree
shaped like the payload holding U[-0.5, 0.5) in each leaf's own dtype.
The reference draws it from ``jax.random`` keys, which torch cannot
reproduce, so a parity run hands the reference's draws in, and
:func:`uniform_noise` draws fresh noise from a ``torch.Generator``.
Every quantizer also takes a client-stacked tree (``stacked=True``:
every leaf leads with the client axis C, and int8 keeps one scale per
client), the reference's ``vmap`` written out.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.parameterization import PFEDPARA_LOCAL_KEYS as PFEDPARA_LOCAL
from repro_torch.tree import tree_leaves, tree_map


def split_pfedpara(params: Any) -> Tuple[Any, Any]:
    """(global_tree, local_tree): x2/y2 subtree leaves stay local, the
    rest (x1/y1, dense weights, norms) is transferred.

    List/tuple nodes keep ``None`` placeholders at pruned positions so
    the two halves stay positionally aligned."""
    def walk_local(node, keep_local: bool):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                sub = walk_local(v, keep_local or k in PFEDPARA_LOCAL)
                if sub is not None:
                    out[k] = sub
            return out or None
        if isinstance(node, (list, tuple)):
            subs = type(node)(walk_local(v, keep_local) for v in node)
            return subs if any(s is not None for s in subs) else None
        return node if keep_local else None

    def walk_global(node):
        if isinstance(node, dict):
            out = {k: walk_global(v) for k, v in node.items()
                   if k not in PFEDPARA_LOCAL}
            return {k: v for k, v in out.items() if v is not None} or None
        if isinstance(node, (list, tuple)):
            return type(node)(walk_global(v) for v in node)
        return node

    return walk_global(params), walk_local(params, False)


def merge_pfedpara(global_tree: Any, local_tree: Any) -> Any:
    """Inverse of :func:`split_pfedpara`. Keys come in the global half's
    order, then the local half's new ones."""
    if isinstance(global_tree, dict) or isinstance(local_tree, dict):
        g_d = global_tree if isinstance(global_tree, dict) else {}
        l_d = local_tree if isinstance(local_tree, dict) else {}
        keys = list(g_d) + [k for k in l_d if k not in g_d]
        out = {}
        for k in keys:
            g, loc = g_d.get(k), l_d.get(k)
            if g is None:
                out[k] = loc
            elif loc is None:
                out[k] = g
            else:
                out[k] = merge_pfedpara(g, loc)
        return out
    if isinstance(global_tree, (list, tuple)) and isinstance(local_tree, (list, tuple)):
        if len(global_tree) != len(local_tree):
            raise ValueError(
                "merge_pfedpara: misaligned sequence nodes "
                f"({len(global_tree)} vs {len(local_tree)} entries); "
                "split_pfedpara keeps None placeholders so halves must "
                "have equal length")
        return type(global_tree)(
            merge_pfedpara(g, loc) for g, loc in zip(global_tree, local_tree))
    return global_tree if global_tree is not None else local_tree


# ------------------------------------------------------------ quantization

def quantize_fp16(tree: Any) -> Any:
    """Every leaf cast to fp16 (the fp16 wire)."""
    return tree_map(lambda x: x.to(torch.float16), tree)


def dequantize_fp16(tree: Any) -> Any:
    """Every leaf widened to fp32."""
    return tree_map(lambda x: x.float(), tree)


def uniform_noise(tree: Any, gen: torch.Generator) -> Any:
    """U[-0.5, 0.5) rounding noise shaped like ``tree``, each leaf in its
    own floating dtype (fp32 for integer leaves), drawn from ``gen`` (a
    generator on the leaves' device) leaf by leaf in tree order."""
    def draw(x):
        dt = x.dtype if x.is_floating_point() else torch.float32
        return (torch.rand(x.shape, generator=gen, dtype=dt, device=x.device)
                - 0.5)

    return tree_map(draw, tree)


def position_noise(like: Any, round_idx: int, position: int,
                   device: Any) -> Any:
    """The server's default int8 rounding noise for one position's wire
    tree ``like``: :func:`uniform_noise` from a generator on ``device``
    seeded from (round, position), the dependence of the reference's
    ``fold_in(PRNGKey(round), position)``."""
    gen = torch.Generator(device).manual_seed((round_idx << 32) + position)
    return uniform_noise(like, gen)


def _int8_leaf(x: torch.Tensor, noise: torch.Tensor, stacked: bool) -> dict:
    if stacked:   # one scale per client: the max over all but the lead
        amax = x.abs().reshape(x.shape[0], -1).amax(dim=1)
    else:
        amax = x.abs().amax()
    # divide by a tensor on the leaf's device: PyTorch multiplies by the
    # reciprocal of a host scalar on the card, which can move the scale
    # by an ulp against the host's (and the reference's) true division
    scale = torch.clamp_min(amax, 1e-12) / amax.new_tensor(127.0)
    y = x / scale.reshape(scale.shape + (1,) * (x.ndim - scale.ndim))
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_int8(tree: Any, noise: Any, stacked: bool = False) -> Any:
    """Per-tensor symmetric int8 with stochastic rounding: every leaf x
    becomes ``{"q": int8, "scale"}`` with scale = max|x| / 127 and
    q = clip(round(x / scale + noise), -127, 127). ``noise`` is shaped
    like ``tree`` (U[-0.5, 0.5), each leaf's own dtype). With
    ``stacked`` every leaf leads with the client axis and the scale is
    per client, shape (C,)."""
    if noise is None:
        raise ValueError("quantize_int8 requires its rounding noise")
    return tree_map(lambda x, n: _int8_leaf(x, n, stacked), tree, noise)


def _is_qnode(n: Any) -> bool:
    return isinstance(n, dict) and set(n) == {"q", "scale"}


def dequantize_int8(tree: Any) -> Any:
    """``{"q", "scale"}`` nodes back to fp32 q · scale; a per-client (C,)
    scale broadcasts over its client's row. Other leaves pass."""
    def walk(n):
        if _is_qnode(n):
            q, s = n["q"], n["scale"]
            return q.float() * s.reshape(s.shape + (1,) * (q.ndim - s.ndim))
        if isinstance(n, dict):
            return {k: walk(v) for k, v in n.items()}
        if isinstance(n, (list, tuple)):
            return type(n)(walk(v) for v in n)
        return n

    return walk(tree)


def quantized_bytes(tree: Any, scheme: str) -> int:
    """Wire bytes of ``tree`` under ``scheme`` (int8 | fp16 | anything
    else: fp32). ``{"q", "scale"}`` subtrees count exactly whatever the
    scheme (q at its stored itemsize, 4 bytes per scale); plain leaves
    are priced by the scheme (int8: 1 byte a value and a 4-byte scale
    per leaf)."""
    qb, plain = 0, []

    def walk(n):
        nonlocal qb
        if _is_qnode(n):
            q, s = n["q"], n["scale"]
            qb += q.numel() * q.element_size() + 4 * max(s.numel(), 1)
        elif isinstance(n, dict):
            for v in n.values():
                walk(v)
        elif isinstance(n, (list, tuple)):
            for v in n:
                walk(v)
        elif isinstance(n, torch.Tensor):
            plain.append(n)

    walk(tree)
    n = sum(x.numel() for x in plain)
    if scheme == "int8":
        return qb + n + 4 * len(plain)
    if scheme == "fp16":
        return qb + 2 * n
    return qb + 4 * n


def quantize_dequantize(tree: Any, scheme: str, noise: Optional[Any] = None,
                        stacked: bool = False) -> Any:
    """One simulated quantization round trip under ``scheme`` (int8 |
    fp16 | anything else: identity); ``noise`` as :func:`quantize_int8`
    takes it, by default drawn from a generator seeded 0 (the
    reference's ``PRNGKey(0)`` default)."""
    if scheme == "int8":
        if noise is None:
            dev = tree_leaves(tree)[0].device
            noise = uniform_noise(tree, torch.Generator(dev).manual_seed(0))
        return dequantize_int8(quantize_int8(tree, noise, stacked))
    if scheme == "fp16":
        return dequantize_fp16(quantize_fp16(tree))
    return tree


# ------------------------------------------------------------ accounting

class CommLog:
    """Accumulates up/down-link wire bytes over an FL run (paper Fig. 3):
    exact integers from the active codec's ``wire_bytes``, already summed
    over the round's participants."""

    def __init__(self):
        self.up_bytes = 0
        self.down_bytes = 0
        self.rounds = 0

    def log_round(self, down_bytes: int, up_bytes: int):
        """Accumulate one round's exact wire bytes (per link)."""
        self.down_bytes += int(down_bytes)
        self.up_bytes += int(up_bytes)
        self.rounds += 1

    @property
    def total_gb(self) -> float:
        return (self.up_bytes + self.down_bytes) / 1e9
