"""pFedPara tree split (the one piece of the FL wire layer that serving
needs; the rest of ``fl/comm.py`` comes with the training slice)."""
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
