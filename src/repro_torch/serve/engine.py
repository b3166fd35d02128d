"""The serve engine (PyTorch): checkpoint -> per-layer plan -> cache ->
decode.

``ServeEngine`` glues the serving stack together, as the reference's
``repro.serve.ServeEngine`` does:

1. **Params** — a trained global tree (factor nodes intact, layers
   stacked) plus, for pFedPara, each user's personal half; or, through
   :meth:`ServeEngine.from_checkpoint` and :func:`load_fl_checkpoint`,
   both read from an FL training checkpoint (the port's or the
   reference's; ``repro_torch.checkpoint``) without a target structure.
2. **Plan** — ``cost_model.plan_params`` decides precompose-vs-fused per
   layer (analytic roofline, or measured on the card; ``mode`` forces
   either branch).
3. **Cache** — ``cache.build_serve_params`` rewrites the tree per the
   plan, one layer at a time. Per-user factors stack into a
   :class:`UserArena`.
4. **Serve** — prefill, then greedy decode. The KV cache is updated in
   place.

Every projection goes through ``repro_torch.kernels.ops``: on the card
the hand-written kernels (K5/K6 compose the precomposed caches, K8
reads them, K1 for fused prefill, K10 for many-user pFedPara), on the
host their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, unflatten_paths
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import comm
from repro_torch.nn.transformer import ModelOptions, build_model
from repro_torch.serve import cost_model
from repro_torch.serve.cache import build_serve_params, serve_state_bytes
from repro_torch.serve.user_arena import UserArena, inject_users
from repro_torch.tree import tree_to


def load_fl_checkpoint(path: str, step: Optional[int] = None,
                       device: DeviceLike = None
                       ) -> Tuple[Any, Dict[int, Any], Dict, int]:
    """Restore an FL training checkpoint for serving, onto ``device``
    (``cuda`` by default; raises without a card).

    Returns ``(global_params, local_trees, extra, step)``:
    ``global_params`` is the trained model (pFedPara: the global tree,
    whose x2/y2 are the initial personal half), ``local_trees`` maps
    client id -> personal tree (empty for a run without
    personalization). Client ids are discovered from the checkpoint's
    paths: no target structure is needed."""
    dev = resolve_device(device)
    by_path, extra, step = CheckpointManager(path).restore_items(step)
    global_params = unflatten_paths(by_path, prefix="global_params")
    if not global_params:
        raise ValueError(f"checkpoint at {path} has no global_params")
    cids = sorted({p.split("/")[1] for p in by_path
                   if p.startswith("local_trees/")}, key=int)
    local_trees = {int(c): tree_to(unflatten_paths(
        by_path, prefix=f"local_trees/{c}"), dev) for c in cids}
    return tree_to(global_params, dev), local_trees, extra, step


class ServeEngine:
    """Decode engine over a planned serve-params tree (module docstring).

    Args:
        cfg: the architecture the params belong to.
        global_params: global tree (factor nodes intact, layers stacked).
        local_trees: optional ``{uid: personal_tree}`` (pFedPara).
        mode: ``precompose`` | ``fused`` | ``auto`` — per-layer layout.
        cache_dtype: ``int8`` | ``fp16`` precomposed-cache precision.
        batch: decode batch the plan optimizes for (and the cohort
            width when users are resident).
        measure: time both branches per distinct (m, n, r) on the card.
        opts: ModelOptions overrides (dtype, attn_chunk).
        device: where to serve; ``None`` means ``cuda`` (raises without
            a card), ``"cpu"`` runs the plain versions.
    """

    def __init__(self, cfg: ArchConfig, global_params: Any,
                 local_trees: Optional[Dict[Any, Any]] = None, *,
                 mode: str = "auto", cache_dtype: str = "int8",
                 batch: int = 1, measure: bool = False,
                 opts: Optional[ModelOptions] = None,
                 device: DeviceLike = None):
        if mode not in ("precompose", "fused", "auto"):
            raise ValueError(f"mode must be precompose|fused|auto, got {mode}")
        self.device = resolve_device(device)
        kind = cfg.param.kind
        self.mode = mode
        self.cache_dtype = cache_dtype
        self.batch = int(batch)
        self.arena = (UserArena.create(local_trees, self.device)
                      if local_trees else None)
        if kind == "pfedpara" and self.arena is not None:
            # personalized serving replaces the global copy of x2/y2 per
            # user, so the serve tree starts from the global half only
            global_params = comm.split_pfedpara(global_params)[0]
        global_params = tree_to(global_params, self.device)

        self.plan = cost_model.plan_params(
            global_params, kind, batch=self.batch, mode=mode,
            weight_dtype=cache_dtype,
            users=self.arena.n_users if self.arena else 0, measure=measure,
            device=self.device)
        with torch.no_grad():
            self.serve_params = build_serve_params(global_params, kind,
                                                   self.plan, cache_dtype)

        # decode rows route fused layers through the Gram identity
        # whenever the plan picked it; prefill's larger row counts take
        # the tile kernel
        gram = any(d.mode == "fused" and d.impl == "gram"
                   for d in self.plan.values())
        self.cfg = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, gram_batch=self.batch if gram else 0))
        base = opts or ModelOptions(attn_chunk=64)
        self.opts = dataclasses.replace(base, use_kernels=True)
        self.model = build_model(self.cfg, self.opts)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ArchConfig, *,
                        step: Optional[int] = None, **kw) -> "ServeEngine":
        """An engine straight from an FL training checkpoint directory:
        its global params and, for pFedPara, every client's personal
        tree as a resident user (keyword args go to the constructor,
        ``device`` included)."""
        global_params, local_trees, _extra, _step = load_fl_checkpoint(
            path, step, kw.get("device"))
        return cls(cfg, global_params, local_trees or None, **kw)

    # -------------------------------------------------------------- compute
    def _params_for(self, user_ids: Optional[Sequence[Any]], batch: int):
        if self.arena is None:
            return self.serve_params
        if user_ids is None:
            user_ids = [self.arena.uids[0]] * batch
        rows = self.arena.rows_for(user_ids)
        return inject_users(self.serve_params, self.arena.gather(rows))

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache on the engine's device."""
        return self.model.init_cache(batch, max_seq, self.device)

    @torch.no_grad()
    def prefill(self, tokens, cache, user_ids: Optional[Sequence] = None):
        """Run the prompt through the model; returns (cache, logits)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        params = self._params_for(user_ids, tokens.shape[0])
        return self.model.prefill(params, tokens, cache)

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int,
                    user_ids: Optional[Sequence] = None):
        """One decode step for tokens (B, 1) at position ``pos``; the
        cache is updated in place. Returns (logits, cache)."""
        token = torch.as_tensor(token, device=self.device)
        params = self._params_for(user_ids, token.shape[0])
        return self.model.decode_step(params, cache, token, int(pos))

    @torch.no_grad()
    def generate(self, prompts, gen_len: int,
                 user_ids: Optional[Sequence] = None) -> torch.Tensor:
        """Greedy-decode ``gen_len`` tokens after prefilling ``prompts``
        (B, S); returns (B, gen_len) token ids on the host."""
        tokens = torch.as_tensor(prompts, device=self.device)
        B, S = tokens.shape
        cache = self.init_cache(B, S + gen_len)
        cache, logits = self.prefill(tokens, cache, user_ids)
        out: List[torch.Tensor] = []
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(gen_len):
            out.append(tok[:, 0])
            logits, cache = self.decode_step(cache, tok, S + i, user_ids)
            tok = torch.argmax(logits, -1)[:, None]
        return torch.stack(out, 1).cpu()

    # ------------------------------------------------------------ accounting
    def decision_table(self) -> List[Dict[str, Any]]:
        """Per-layer decision rows (path, dims, mode, impl, predicted /
        measured µs, analytic crossover batch)."""
        return cost_model.decision_table(self.plan)

    def state_bytes(self) -> int:
        """Bytes of the shared serve weights (excludes the per-user
        factor arena — see :meth:`arena_bytes`)."""
        return serve_state_bytes(self.serve_params)

    def arena_bytes(self) -> int:
        """Bytes of the stacked per-user factors."""
        return self.arena.nbytes() if self.arena else 0
