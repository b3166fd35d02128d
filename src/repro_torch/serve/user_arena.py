"""Stacked per-user personalization factors for many-user serving.

pFedPara keeps each user's (X2, Y2) factors personal. At serve time the
engine hosts many such users at once: every personal tree lives ONCE as
stacked tensors with a leading user-row axis, a step gathers its
cohort's rows with one ``index_select`` per leaf, and the gathered
slices are injected next to the shared weights as ``ux2``/``uy2`` so
:func:`repro_torch.nn.layers.dense` routes them into the cache+residual
kernel (K10) or the per-user Gram path. Resident memory grows only by
the factor rows — 2r(m+n) floats per user per layer, never m·n.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from repro_torch.tree import tree_bytes, tree_leaves, tree_map


def _is_personal_node(node: Any) -> bool:
    return isinstance(node, dict) and "x2" in node and "y2" in node \
        and "x1" not in node


class UserArena:
    """Stacked per-user (X2, Y2) factor trees.

    ``tree`` mirrors the *local* half of ``split_pfedpara`` with every
    leaf stacked to ``(U, ...)``. ``uids`` maps external user ids to
    rows; unknown users resolve to row 0's factors.
    """

    def __init__(self, tree: Any, uids: Sequence[Any]):
        self.tree = tree
        self.uids: List[Any] = list(uids)
        self._row: Dict[Any, int] = {u: i for i, u in enumerate(self.uids)}

    @classmethod
    def create(cls, local_trees: Dict[Any, Any], device="cpu") -> "UserArena":
        """Stack ``{uid: local_tree}`` into one arena on ``device``; uids
        keep their insertion order as rows."""
        if not local_trees:
            raise ValueError("UserArena.create: no users")
        uids = list(local_trees)
        stacked = tree_map(
            lambda *leaves: torch.stack([x.to(device) for x in leaves]),
            *[local_trees[u] for u in uids])
        return cls(stacked, uids)

    @property
    def n_users(self) -> int:
        return len(self.uids)

    def nbytes(self) -> int:
        """Total bytes held by the stacked factors."""
        return tree_bytes(self.tree)

    def rows_for(self, uids: Sequence[Any]) -> torch.Tensor:
        """(B,) row indices for a request cohort (host-side id lookup)."""
        dev = tree_leaves(self.tree)[0].device
        return torch.tensor([self._row.get(u, 0) for u in uids],
                            dtype=torch.long, device=dev)

    def gather(self, rows: torch.Tensor) -> Any:
        """The cohort's local trees stacked along a leading (B,) axis."""
        return tree_map(lambda a: a.index_select(0, rows), self.tree)


def inject_users(serve_params: Any, gathered: Any) -> Any:
    """Overlay a gathered cohort onto serve params: every personal
    ``{'x2', 'y2'}`` node in ``gathered`` contributes ``ux2``/``uy2``
    keys to the matching serve node.

    Layer-stacked leaves need one reorientation: serve leaves are
    (L, m, r) and the model slices the layer axis, while a gather stacks
    users leading, (B, L, m, r). Gathered 4-D leaves are viewed as
    (L, B, m, r) (no copy), so a layer slice carries the cohort; each
    user's (m, r) slab stays contiguous, which is what K10 reads.
    """
    def overlay(sp, gp):
        if _is_personal_node(gp):
            if not isinstance(sp, dict):
                raise ValueError("inject_users: serve tree misses a "
                                 "personalized node present in the arena")

            def orient(leaf):
                return leaf.movedim(0, 1) if leaf.ndim == 4 else leaf
            return {**sp, "ux2": orient(gp["x2"]), "uy2": orient(gp["y2"])}
        if isinstance(gp, dict):
            out = {k: overlay(sp[k], v) if k in sp else sp.get(k)
                   for k, v in gp.items()}
            out.update({k: v for k, v in sp.items() if k not in gp})
            return out
        if isinstance(gp, (list, tuple)):
            return type(gp)(overlay(s, g) for s, g in zip(sp, gp))
        return sp

    return overlay(serve_params, gathered)
