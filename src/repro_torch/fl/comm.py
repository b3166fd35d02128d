"""Payload selection and byte accounting on the FL wire (PyTorch), the
counterpart of the reference's ``repro/fl/comm.py``: the pFedPara split
and merge (paper §2.3: only the global half x1/y1 travels) and
:class:`CommLog`. The quantizers arrive with the codec stages
(ROADMAP A7)."""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.core.parameterization import PFEDPARA_LOCAL_KEYS as PFEDPARA_LOCAL


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
