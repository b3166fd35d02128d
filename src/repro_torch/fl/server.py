"""FL server (PyTorch): sampling, straggler-aware aggregation,
personalization — the counterpart of the reference's
``repro/fl/server.py`` with its sequential, batched and streaming
engines.

Each round draws, host side and with the reference's numpy draws in the
reference's order (``_select_round``: ``rng.choice``, then
``rng.lognormal`` in ``_simulate_latency``, then ``rng.rand``), the
sampled clients, their simulated latencies and dropouts, and the
boolean arrived-mask over the sampled order: a client participates iff
it survived dropout, beat the straggler deadline and is among the first
``n_target`` arrivals. The mask equals the reference's bit for bit.
Then the configured engine (``ServerConfig.engine``) trains:

  sequential — the arrived clients one after another (``local_update``);
               their uploads are averaged weighted by local dataset size;
  batched    — ``repro_torch.fl.batch_engine.ClientBatch``: every sampled
               client stacked along a client axis and trained together
               (the client-stacked kernels on the card), the mask giving
               a client that did not arrive aggregation weight 0;
  streaming  — ``repro_torch.fl.stream_engine.StreamingRound``: the same
               in chunks of ``client_chunk`` clients, uploads folded into
               a running fp32 sum by the dequant-accumulate kernel (K7).

The strategy's server update runs, and ``CommLog`` charges the codecs'
exact wire bytes. All engines write state back only for the arrived
clients, into host dicts (``client_states``, ``local_trees``).

Codecs (``repro_torch.fl.codecs``; ``ServerConfig.uplink_codec`` /
``downlink_codec``, or the legacy ``uplink_quant`` / ``downlink_quant``
single-stage specs): the broadcast is encoded and decoded once a round
(``_encode_downlink``; the delta reference ``_down_ref`` and the error
feedback ``_down_ef`` live on the server), and each client's upload is
encoded against the decoded broadcast, its top-k error feedback
threaded through ``client_states[cid]["_ef_up"]`` (stacked in the
batched and streaming engines' client state). The int8 stage's rounding
noise depends only on the round and the client's position in the
round's sampled order (the downlink's position is ``0x7FFFFFFF``), as
the reference's ``fold_in(PRNGKey(round), position)`` keys do, so the
three engines quantize alike: by default it is drawn on the run's
device from a ``torch.Generator`` seeded from (round, position);
``FLServer(quant_noise=...)`` replaces the draw (a test hook that hands
in the reference's noise).

Personalization modes:
  none      — vanilla FL (upload/download everything)
  pfedpara  — paper §2.3: only x1/y1 (the global halves) are
              transferred; x2/y2 persist per client
  fedper    — the last layer stays local
  local     — local-only baseline (no aggregation)

Crash/resume: ``save_checkpoint`` writes the complete server state at a
round boundary (the arrays, and in ``extra`` the round index, the numpy
RNG state, the wire-byte totals and the history, as the reference
writes them) through a ``repro_torch.checkpoint.CheckpointManager``;
``restore_checkpoint`` reads it back without knowing its structure, and
a restored server continues bitwise as the uninterrupted run would.
``run(..., ckpt=...)`` checkpoints every ``ckpt_every`` rounds.
Checkpoints are in the reference's format: either package reads the
other's.

Not ported yet, and refused at construction with the ROADMAP item that
brings them: the async engine (A3), fleet traces, the arena store and
chunked data (A4), rank tiers, faults, defenses and round recovery
(A5). A checkpoint that holds their state raises on restore.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import unflatten_paths
from repro_torch.data.loader import (client_epochs, client_step_count,
                                     stack_client_epochs)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import codecs, comm
from repro_torch.fl.arrivals import arrival_mask
from repro_torch.fl.batch_engine import ClientBatch
from repro_torch.fl.client import ClientConfig, init_client_state, local_update
from repro_torch.fl.stream_engine import (StreamingRound, chunk_layout,
                                          from_chunks, to_chunks)
from repro_torch.fl.strategies import (Strategy, tree_mean, tree_stack,
                                       tree_zeros)
from repro_torch.fl.trace import spawn_seeds
from repro_torch.tree import tree_index, tree_map, tree_to

FEDPER_LOCAL_KEYS = ("head", "fc2", "b2")   # model-specific last layers


def _loss_stats(losses) -> tuple:
    """``(mean, nonfinite_count)`` over per-client round losses; the mean
    ignores non-finite entries."""
    arr = np.asarray(losses).reshape(-1)
    if arr.size == 0:
        return float("nan"), 0
    fin = np.isfinite(arr)
    mean = float(arr[fin].mean()) if fin.any() else float("nan")
    return mean, int((~fin).sum())


def _to_plain(obj):
    """Numpy and torch scalars and arrays inside ``obj`` as plain Python
    (lists, ints, floats), so the history serializes into a checkpoint
    manifest."""
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return _to_plain(obj.tolist())
    if isinstance(obj, torch.Tensor):
        return _to_plain(obj.detach().cpu().tolist())
    return obj


# checkpoint sections of state the port does not carry yet
_UNPORTED_SECTIONS = {
    "arena": "the arena store (ROADMAP A4)",
    "async": "the async engine's buffer (ROADMAP A3)",
    "client_versions": "the async engine's client versions (ROADMAP A3)",
}

# the downlink's position in the int8 noise stream, apart from every
# client's position in the round's sampled order (the reference's)
DOWNLINK_POSITION = 0x7FFFFFFF


@dataclass
class ServerConfig:
    """Round/selection/wire/engine settings for :class:`FLServer`: every
    field of the reference's ``ServerConfig`` with the same defaults.
    The fields of the parts not ported yet must keep their defaults
    (see the module docstring)."""

    clients: int = 100
    participation: float = 0.16
    rounds: int = 20
    lr_decay: float = 0.992
    personalization: str = "none"      # none | pfedpara | fedper | local
    uplink_quant: str = "fp32"         # legacy: fp32 | fp16 | int8
    downlink_quant: str = "fp32"       # legacy: fp32 | fp16 | int8
    uplink_codec: str = ""             # codec spec, e.g. "delta|topk0.1|int8"
    downlink_codec: str = ""           # overrides *_quant when non-empty
    oversample: float = 0.0            # straggler over-sampling fraction
    deadline_quantile: float = 0.9
    straggler_sigma: float = 0.5       # lognormal sigma of compute time
    bandwidth_mbps: float = 10.0
    dropout_prob: float = 0.0          # random client failure per round
    staleness_mix: float = 0.0         # >0: staleness-weighted mixing
    engine: str = "sequential"         # sequential | batched | streaming
                                       # (async: not ported yet)
    client_chunk: int = 16             # streaming/async: clients per step
    buffer_k: int = 0                  # async: arrivals per version bump
    staleness: str = "constant"        # async staleness weight s(tau)
    max_staleness: int = -1            # async: drop staler arrivals
    state_store: str = "dict"          # dict (arena: not ported yet)
    data_stream: str = "eager"         # eager (chunked: not ported yet)
    trace: Optional[Any] = None        # fleet trace (not ported yet)
    gamma_tiers: tuple = ()            # capacity tiers (not ported yet)
    tier_assignment: str = "round_robin"
    defense: str = "none"              # none (clip | trimmed: not ported)
    defense_z: float = 3.0
    defense_clip: float = 1.0
    defense_trim: float = 0.1
    faults: Optional[Any] = None       # fault plan (not ported yet)
    recover_frac: float = 0.5
    recover_retries: int = 0           # round recovery (not ported yet)
    seed: int = 0


def _refuse_unported(scfg: ServerConfig) -> None:
    """Raise for every setting whose machinery is not ported yet."""
    if scfg.engine == "async":
        raise NotImplementedError(
            "engine 'async' is not ported yet (ROADMAP A3); the "
            "sequential, batched and streaming engines are")
    if scfg.engine not in ("sequential", "batched", "streaming"):
        raise ValueError(f"unknown engine {scfg.engine!r} (expected "
                         "sequential | batched | streaming | async)")
    if scfg.personalization not in ("none", "pfedpara", "fedper", "local"):
        raise ValueError(f"unknown personalization {scfg.personalization!r}")
    unported = (
        (scfg.trace is not None, "trace (fleet traces, ROADMAP A4)"),
        (scfg.state_store != "dict", "state_store != 'dict' (ROADMAP A4)"),
        (scfg.data_stream != "eager", "data_stream != 'eager' (ROADMAP A4)"),
        (bool(scfg.gamma_tiers), "gamma_tiers (rank tiers, ROADMAP A5)"),
        (scfg.faults is not None, "faults (ROADMAP A5)"),
        (scfg.defense != "none", "defense != 'none' (ROADMAP A5)"),
        (scfg.recover_retries > 0, "recover_retries > 0 (ROADMAP A5)"),
    )
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class FLServer:
    """The federated-learning server/simulator (see the module
    docstring).

    Args:
        loss_fn: ``loss_fn(params, batch) -> scalar tensor``; the batch
            is a dict of tensors on the params' device.
        global_params: initial global model tree of tensors (FedPara
            factors are just leaves), moved to ``device``.
        data: dataset dict of numpy arrays; clients index it via
            ``partitions``.
        partitions: per-client index arrays into ``data``.
        strategy: a ``repro_torch.fl.strategies.Strategy``.
        client_cfg: local-SGD settings (lr, batch, epochs, ...).
        server_cfg: round/selection/codec settings.
        eval_fn: optional ``eval_fn(global_params) -> float`` recorded per
            round in ``history[i]["eval"]``.
        device: where the run trains: ``cuda`` by default (raises
            without a card), ``"cpu"`` for the plain versions on the host.
        loss_fn_clients: the client-stacked loss the batched and
            streaming engines train through (required for them),
            ``loss_fn_clients(params, batch) -> (C,)`` with every leaf
            and the batch leading with the client axis (e.g.
            ``nn.recurrent.mlp_loss_clients``).
        quant_noise: optional ``quant_noise(round_idx, position, tree)
            -> noise tree`` replacing the int8 stage's default draw (a
            test hook): ``tree`` is one client's (unstacked) int8-stage
            input, the result is shaped like it (U[-0.5, 0.5), tensors
            or numpy arrays, moved to the run's device in each leaf's
            dtype). ``position`` is the client's index in the round's
            sampled order (pad slots follow the cohort), or
            ``DOWNLINK_POSITION`` for the broadcast.

    After ``run()``: ``global_params`` holds the trained model,
    ``history`` the per-round records (participants, ``arrived_mask``,
    mean loss, exact ``down_bytes``/``up_bytes``), ``comm_log`` the
    cumulative wire bytes, ``client_states``/``local_trees`` the
    per-client strategy state and personalization residents.
    """

    def __init__(
        self,
        loss_fn: Callable,
        global_params: Any,
        data: Dict[str, np.ndarray],
        partitions: List[np.ndarray],
        strategy: Strategy,
        client_cfg: ClientConfig,
        server_cfg: ServerConfig,
        eval_fn: Optional[Callable] = None,
        device: DeviceLike = None,
        loss_fn_clients: Optional[Callable] = None,
        quant_noise: Optional[Callable] = None,
    ):
        _refuse_unported(server_cfg)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.global_params = tree_to(global_params, self.device)
        self.data = data
        self.partitions = partitions
        self.strategy = strategy
        self.ccfg = client_cfg
        self.scfg = server_cfg
        self.eval_fn = eval_fn
        self.rng = np.random.RandomState(server_cfg.seed)
        self.round_idx = 0
        self.comm_log = comm.CommLog()
        self.server_state = (strategy.server_init(global_params)
                             if strategy.server_init else {})
        self.client_states: Dict[int, Dict] = {}
        self.local_trees: Dict[int, Any] = {}   # personalization residents
        self.history: List[Dict] = []
        # the last round's decoded broadcast, as the reference keeps it
        # (what its stale-replay faults re-upload); checkpointed
        self._stale_ref: Any = None
        self.round_seconds: List[float] = []   # host wall time per round
        self.uplink_codec = codecs.make_codec(
            server_cfg.uplink_codec or server_cfg.uplink_quant)
        self.downlink_codec = codecs.make_codec(
            server_cfg.downlink_codec or server_cfg.downlink_quant)
        self._down_ref: Any = None   # last decoded broadcast (delta ref)
        self._down_ef: Any = None    # server-side downlink error feedback
        self.quant_noise = quant_noise
        self._engine = self._stream = None
        if server_cfg.engine != "sequential" and loss_fn_clients is None:
            raise ValueError(f"engine {server_cfg.engine!r} trains through "
                             "a client-stacked loss: pass loss_fn_clients")
        if server_cfg.engine == "batched":
            self._engine = ClientBatch(
                loss_fn=loss_fn_clients, strategy=strategy,
                client_cfg=client_cfg,
                personalization=server_cfg.personalization,
                uplink_codec=self.uplink_codec,
                fedper_local_keys=FEDPER_LOCAL_KEYS)
        elif server_cfg.engine == "streaming":
            self._stream = StreamingRound(
                loss_fn=loss_fn_clients, strategy=strategy,
                client_cfg=client_cfg,
                personalization=server_cfg.personalization,
                uplink_codec=self.uplink_codec,
                fedper_local_keys=FEDPER_LOCAL_KEYS,
                chunk=max(1, int(server_cfg.client_chunk)))

    # ------------------------------------------------------------ payload
    def _download_payload(self, cid: int) -> Any:
        p = self.global_params
        mode = self.scfg.personalization
        if mode == "pfedpara":
            glob, _ = comm.split_pfedpara(p)
            return glob
        if mode == "fedper":
            return {k: v for k, v in p.items() if k not in FEDPER_LOCAL_KEYS}
        return p

    def _client_full_params(self, cid: int, download: Any) -> Any:
        """Client-side model assembly from the (decoded) downlink payload
        plus personalization residents; first-time participants take
        their resident half from the global init."""
        mode = self.scfg.personalization
        if mode == "none":
            return download
        resident = self.resident_of(cid)
        if mode == "pfedpara":
            if resident is None:
                resident = comm.split_pfedpara(self.global_params)[1]
            return comm.merge_pfedpara(download, resident)
        if mode == "fedper":
            if resident is None:
                resident = {k: v for k, v in self.global_params.items()
                            if k in FEDPER_LOCAL_KEYS}
            merged = dict(download)
            merged.update(resident)
            return merged
        if mode == "local":
            return resident if resident is not None else download
        return download

    def resident_of(self, cid: int) -> Any:
        """One client's personalization resident (``None`` if it never
        participated)."""
        return self.local_trees.get(cid)

    def client_state_of(self, cid: int) -> Dict:
        """One client's strategy state (``{}`` if it never
        participated)."""
        return self.client_states.get(cid, {})

    def _split_upload(self, cid: int, trained: Any):
        """Split a trained tree into (upload, resident); the resident
        lands in ``local_trees[cid]``."""
        target = self.local_trees
        mode = self.scfg.personalization
        if mode == "pfedpara":
            glob, loc = comm.split_pfedpara(trained)
            target[cid] = loc
            return glob
        if mode == "fedper":
            target[cid] = {k: trained[k] for k in FEDPER_LOCAL_KEYS
                           if k in trained}
            return {k: v for k, v in trained.items()
                    if k not in FEDPER_LOCAL_KEYS}
        if mode == "local":
            target[cid] = trained
            return None
        return trained

    def _apply_aggregated(self, new_global_part: Any, agg_target: Any):
        """Write the aggregated global slice back, with optional
        staleness-weighted mixing."""
        scfg = self.scfg
        if scfg.staleness_mix > 0:
            a = scfg.staleness_mix
            new_global_part = tree_map(lambda old, new: (1 - a) * old + a * new,
                                       agg_target, new_global_part)
        if scfg.personalization == "none":
            self.global_params = new_global_part
        elif scfg.personalization == "pfedpara":
            self.global_params = comm.merge_pfedpara(
                new_global_part, comm.split_pfedpara(self.global_params)[1])
        else:
            self.global_params = {**self.global_params, **new_global_part}

    def _round_bytes(self, mask, down_bytes: int, down_dec: Any) -> tuple:
        """Exact (down, up) wire bytes for the round's arrived clients:
        participants x the payload's codec bytes on each link."""
        n_arrived = int(mask.sum())
        local = self.scfg.personalization == "local"
        up = 0 if local else self.uplink_codec.wire_bytes(down_dec)
        return n_arrived * down_bytes, n_arrived * up

    # ------------------------------------------------------------- round
    def _simulate_latency(self, payload_bytes, n: int) -> np.ndarray:
        comp = self.rng.lognormal(mean=0.0, sigma=self.scfg.straggler_sigma,
                                  size=n)
        comm_s = 8.0 * payload_bytes / (self.scfg.bandwidth_mbps * 1e6)
        return comp + comm_s

    def _select_round(self):
        """Host-side RNG for one round (the reference's legacy path, same
        draws in the same order): sample clients, simulate stragglers and
        dropout, derive the arrived-mask over the sampled order and each
        sampled client's data seed. Download latency is priced at the
        downlink codec's wire bytes."""
        scfg = self.scfg
        n_target = max(1, int(round(scfg.participation * scfg.clients)))
        n_sample = max(n_target, int(round(n_target * (1 + scfg.oversample))))
        n_sample = min(n_sample, scfg.clients)
        sampled = self.rng.choice(scfg.clients, size=n_sample, replace=False)
        lr = self.ccfg.lr * (scfg.lr_decay ** self.round_idx)
        probe_payload = self._download_payload(int(sampled[0]))
        payload_bytes = self.downlink_codec.wire_bytes(probe_payload)
        lat = self._simulate_latency(payload_bytes, len(sampled))
        alive = self.rng.rand(len(sampled)) >= scfg.dropout_prob
        deadline = (np.quantile(lat, scfg.deadline_quantile)
                    if scfg.oversample else np.inf)
        ok = alive & (lat <= deadline)
        mask = arrival_mask(ok, lat, n_target)
        seeds = spawn_seeds(scfg.seed, self.round_idx, len(sampled))
        return sampled, mask, seeds, lr, probe_payload, lat

    def _draw_noise(self, position: int, like: Any) -> Any:
        """int8 rounding noise for one position's wire tree ``like``:
        the ``quant_noise`` hook's, or U[-0.5, 0.5) from a generator on
        the run's device seeded from (round, position)."""
        if self.quant_noise is not None:
            noise = self.quant_noise(self.round_idx, position, like)
            return tree_map(lambda n, a: torch.as_tensor(n).to(
                device=a.device, dtype=a.dtype), noise, like)
        return comm.position_noise(like, self.round_idx, position,
                                   self.device)

    def _noise_stacked(self, positions) -> Callable:
        """The noise source for a client stack: row ``i`` of every leaf
        draws at ``positions[i]``, as that client alone would."""
        return lambda like: tree_stack([
            self._draw_noise(int(p), tree_index(like, i))
            for i, p in enumerate(positions)])

    def _encode_downlink(self, payload: Any):
        """One broadcast encode/decode per round: the decoded payload
        clients train on and its exact per-client wire bytes. Advances
        the delta reference (the last decoded broadcast, which clients
        cache) and the downlink error feedback; the identity codec
        hands the payload through."""
        codec = self.downlink_codec
        if codec.is_identity:
            return payload, codec.wire_bytes(payload)
        if codec.has_delta and self._down_ref is None:
            self._down_ref = tree_map(torch.zeros_like, payload)
        if codec.has_ef and self._down_ef is None:
            self._down_ef = codec.ef_init(payload)
        wire, self._down_ef = codec.encode(
            payload, ref=self._down_ref, ef=self._down_ef,
            noise=functools.partial(self._draw_noise, DOWNLINK_POSITION))
        decoded = codec.decode(wire, ref=self._down_ref)
        if codec.has_delta:
            self._down_ref = decoded
        return decoded, codec.wire_bytes(payload)

    def run_round(self) -> Dict:
        """Execute one federated round end to end (selection, broadcast,
        the configured engine, bookkeeping) and return (and append to
        ``history``) its record. Its host wall time, synchronized with
        the card, goes to ``round_seconds`` (not checkpointed)."""
        t0 = time.perf_counter()
        rec = self._round()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.round_seconds.append(time.perf_counter() - t0)
        return rec

    def _round(self) -> Dict:
        sampled, mask, seeds, lr, probe, lat = self._select_round()
        if not mask.any():   # everyone failed: skip round (fault tolerance)
            self.round_idx += 1
            return {"round": self.round_idx, "participants": 0,
                    "skipped": True}
        down_dec, down_bytes = self._encode_downlink(probe)
        runner = (self._run_round_batched if self._engine is not None else
                  self._run_round_streaming if self._stream is not None else
                  self._run_round_sequential)
        rec = runner(sampled, mask, seeds, lr, down_dec, down_bytes)
        # virtual seconds the sync barrier costs: the round completes
        # when its last arrival lands
        rec["round_latency"] = float(
            np.max(np.asarray(lat)[mask.astype(bool)]))
        rec["comm_gb"] = self.comm_log.total_gb
        self.round_idx += 1
        rec["round"] = self.round_idx
        rec["arrived_mask"] = mask.astype(int).tolist()
        rec["sampled"] = [int(c) for c in sampled]
        if self.eval_fn is not None:
            rec["eval"] = self.eval_fn(self.global_params)
        self.history.append(rec)
        # no engine updates a tree in place, so a reference is enough
        self._stale_ref = down_dec
        return rec

    # ------------------------------------------- sequential reference
    def _run_round_sequential(self, sampled, mask, seeds, lr, down_dec,
                              down_bytes):
        """The reference round: a loop over the arrived clients, then the
        weighted mean of their uploads and the strategy's server update.
        A client appears once per round, so its state and resident are
        written back as it finishes. Returns the round's record."""
        scfg = self.scfg
        up_codec = self.uplink_codec
        uploads, weights, losses = [], [], []
        for i, cid in enumerate(int(c) for c in sampled):
            if not mask[i]:
                continue
            params = self._client_full_params(cid, down_dec)
            state = self._prep_client_state(cid, params, down_dec)
            batches = client_epochs(self.data, self.partitions[cid],
                                    self.ccfg.batch, self.ccfg.epochs,
                                    seed=int(seeds[i]))
            trained, state, m = local_update(
                params, batches, self.loss_fn, self.ccfg, self.strategy,
                client_state=state, lr=lr)
            up = self._split_upload(cid, trained)
            if up is not None:
                up, new_ef = up_codec.encode_decode(
                    up, ref=down_dec, ef=state.get("_ef_up"),
                    noise=functools.partial(self._draw_noise, i))
                if new_ef is not None:
                    state = {**state, "_ef_up": new_ef}
                uploads.append(up)
                weights.append(float(len(self.partitions[cid])))
            self.client_states[cid] = state
            losses.append(m["loss"])

        if uploads and scfg.personalization != "local":
            agg_target = (self.global_params if scfg.personalization == "none"
                          else self._download_payload(-1))
            new_global_part, self.server_state = self.strategy.server_update(
                self.server_state, agg_target, tree_mean(uploads, weights))
            self._apply_aggregated(new_global_part, agg_target)
        rd, ru = self._round_bytes(mask, down_bytes, down_dec)
        self.comm_log.log_round(rd, ru)
        mean_loss, nonfinite = _loss_stats(losses)
        return {
            "participants": int(mask.sum()),
            "sampled": len(sampled),
            "mean_loss": mean_loss,
            "nonfinite_losses": nonfinite,
            "down_bytes": rd,
            "up_bytes": ru,
            "lr": lr,
        }

    def _ensure_ef(self, state: Dict, payload: Any) -> Dict:
        """Attach a zero uplink error-feedback accumulator (payload
        structure) to a client state that does not have one yet."""
        if self.uplink_codec.has_ef and "_ef_up" not in state:
            state = {**state, "_ef_up": self.uplink_codec.ef_init(payload)}
        return state

    def _prep_client_state(self, cid: int, params: Any, down_dec: Any) -> Dict:
        """Round-start client state: stored state or strategy init, with
        the uplink error feedback attached (unless nothing is uploaded)
        and the SCAFFOLD server control variate broadcast in."""
        state = self.client_states.get(cid)
        if state is None:
            state = init_client_state(self.strategy, params)
        if self.scfg.personalization != "local":
            state = self._ensure_ef(state, down_dec)
        if self.strategy.name == "scaffold" and "c" in state:
            c = (tree_zeros(params) if not self.server_state
                 else self.server_state.get("c", tree_zeros(params)))
            state = {**state, "c": c}
        return state

    # ------------------------------------------------ batched engine
    def _stack_cohort(self, cids, down_dec):
        """Round-start params, strategy state and personalization
        residents of the listed clients, each stacked along a client
        axis (``{}`` / ``None`` where the strategy / mode keeps none)."""
        mode = self.scfg.personalization
        full, states, residents = [], [], []
        for cid in cids:
            params = self._client_full_params(cid, down_dec)
            full.append(params)
            states.append(self._prep_client_state(cid, params, down_dec))
            if mode == "pfedpara":
                residents.append(comm.split_pfedpara(params)[1])
            elif mode == "fedper":
                residents.append({k: params[k] for k in FEDPER_LOCAL_KEYS
                                  if k in params})
            elif mode == "local":
                residents.append(params)
        return (tree_stack(full), tree_stack(states) if states[0] else {},
                tree_stack(residents) if residents else None)

    def _commit_stacked(self, cids, mask, new_state, local) -> None:
        """Write the arrived clients' rows of the stacked state and
        residents back into the host dicts; the others keep theirs."""
        for pos in np.nonzero(mask)[0]:
            cid = cids[pos]
            self.client_states[cid] = (tree_index(new_state, int(pos))
                                       if new_state else {})
            if local is not None:
                self.local_trees[cid] = tree_index(local, int(pos))

    def _round_record(self, sampled, mask, last_loss, down_bytes, down_dec,
                      lr, **extra) -> Dict:
        """Charge the round's wire bytes and build its record (the
        reference's keys)."""
        rd, ru = self._round_bytes(mask, down_bytes, down_dec)
        self.comm_log.log_round(rd, ru)
        losses = last_loss.detach().cpu().numpy()[np.nonzero(mask)[0]]
        mean_loss, nonfinite = _loss_stats(losses)
        return {"participants": int(mask.sum()), "sampled": len(sampled),
                **extra, "mean_loss": mean_loss,
                "nonfinite_losses": nonfinite, "down_bytes": rd,
                "up_bytes": ru, "lr": lr}

    def _tensor(self, a) -> torch.Tensor:
        """A host array as a float32 tensor on the run's device."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _run_round_batched(self, sampled, mask, seeds, lr, down_dec,
                           down_bytes):
        """Every sampled client trains in one client-stacked program
        (the arrived ones are written back and aggregated). Returns the
        round's record."""
        scfg = self.scfg
        cids = [int(c) for c in sampled]
        stacked_params, stacked_state, _ = self._stack_cohort(cids, down_dec)
        batches, step_mask = stack_client_epochs(
            self.data, self.partitions, cids, self.ccfg.batch,
            self.ccfg.epochs, seeds)
        sizes = [len(self.partitions[c]) for c in cids]
        agg_target = (self.global_params if scfg.personalization == "none"
                      else self._download_payload(-1))
        (_, new_state, upload, local, last_loss, _, new_global,
         new_server_state) = self._engine.run(
            stacked_params, stacked_state,
            {k: torch.as_tensor(v, device=self.device)
             for k, v in batches.items()},
            self._tensor(step_mask), self._tensor(mask), self._tensor(sizes),
            lr, self.server_state, agg_target, down_dec,
            noise=self._noise_stacked(range(len(cids))))
        self._commit_stacked(cids, mask, new_state, local)
        if upload is not None and scfg.personalization != "local":
            self.server_state = new_server_state
            self._apply_aggregated(new_global, agg_target)
        return self._round_record(sampled, mask, last_loss, down_bytes,
                                  down_dec, lr)

    # ---------------------------------------------- streaming engine
    def _run_round_streaming(self, sampled, mask, seeds, lr, down_dec,
                             down_bytes):
        """The batched round in chunks of ``client_chunk`` clients, the
        uploads folded into a running fp32 sum (K7). Pad slots (the
        cohort rounded up to whole chunks) reuse client 0's state and
        residents with zero batches, arrival mask 0 and size 0. Returns
        the round's record."""
        scfg = self.scfg
        mode = scfg.personalization
        cids = [int(c) for c in sampled]
        C = len(cids)
        chunk, n_chunks, pad = chunk_layout(C, scfg.client_chunk)
        _, stacked_state, stacked_res = self._stack_cohort(
            cids + cids[:1] * pad, down_dec)
        # one round-wide step axis, so every chunk has the same shape
        S = max(client_step_count(len(self.partitions[c]), self.ccfg.batch,
                                  self.ccfg.epochs) for c in cids)
        batches, step_mask = stack_client_epochs(
            self.data, self.partitions, cids, self.ccfg.batch,
            self.ccfg.epochs, [int(s) for s in seeds], pad_steps=max(S, 1),
            pad_clients=pad)
        mask_pad = np.zeros(C + pad, np.float32)
        mask_pad[:C] = mask
        sizes_pad = np.zeros(C + pad, np.float32)
        sizes_pad[:C] = [len(self.partitions[c]) for c in cids]
        agg_target = (self.global_params if mode == "none"
                      else self._download_payload(-1))

        def chunks(tree):
            return to_chunks(tree, n_chunks, chunk)

        (state_ys, local_ys, loss_ys, _, new_global,
         new_server_state) = self._stream.run(
            chunks(stacked_state),
            chunks(stacked_res) if stacked_res is not None else None,
            chunks({k: torch.as_tensor(v, device=self.device)
                    for k, v in batches.items()}),
            chunks(self._tensor(step_mask)), chunks(self._tensor(mask_pad)),
            chunks(self._tensor(sizes_pad)), lr, self.server_state,
            agg_target, down_dec,
            noise_xs=[self._noise_stacked(range(i * chunk, (i + 1) * chunk))
                      for i in range(n_chunks)])
        self._commit_stacked(cids, mask,
                             from_chunks(state_ys) if state_ys else {},
                             from_chunks(local_ys)
                             if local_ys is not None else None)
        if mode != "local":
            self.server_state = new_server_state
            self._apply_aggregated(new_global, agg_target)
        return self._round_record(sampled, mask, from_chunks(loss_ys)[:C],
                                  down_bytes, down_dec, lr, chunks=n_chunks,
                                  client_chunk=chunk)

    # --------------------------------------------------- crash / resume
    def _checkpoint_tree(self) -> Dict:
        """Every array-valued piece of server state as one dict tree
        (client dicts keyed by stringified cid, so the checkpoint's paths
        restore them without a target structure)."""
        tree: Dict[str, Any] = {"global_params": self.global_params,
                                "server_state": self.server_state}
        if self._stale_ref is not None:
            tree["stale_ref"] = self._stale_ref
        if self._down_ref is not None:
            tree["down_ref"] = self._down_ref
        if self._down_ef is not None:
            tree["down_ef"] = self._down_ef
        if self.client_states:
            tree["client_states"] = {str(c): s for c, s
                                     in self.client_states.items()}
        if self.local_trees:
            tree["local_trees"] = {str(c): t for c, t
                                   in self.local_trees.items()}
        return tree

    def save_checkpoint(self, manager) -> str:
        """Checkpoint the complete server state at a round boundary
        (arrays, and the round index, legacy RNG stream, wire-byte totals
        and history in ``extra``) through ``manager``, a
        ``repro_torch.checkpoint.CheckpointManager``; returns the step's
        directory. Restoring it continues the run bitwise."""
        st = self.rng.get_state()
        extra = {
            "round_idx": int(self.round_idx),
            "rng": [st[0], [int(v) for v in st[1]], int(st[2]),
                    int(st[3]), float(st[4])],
            "comm": [int(self.comm_log.down_bytes),
                     int(self.comm_log.up_bytes),
                     int(self.comm_log.rounds)],
            "history": _to_plain(self.history),
        }
        return manager.save(self.round_idx, self._checkpoint_tree(),
                            extra=extra)

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Restore from ``manager`` (the latest step by default) onto the
        run's device and return the restored round index. Structure-free:
        the checkpoint's "/"-joined paths rebuild the nested dicts, so
        per-client state restores without knowing who participated.
        Reads the reference's checkpoints too (codec state included: the
        downlink's ``down_ref`` / ``down_ef`` and each client's
        ``_ef_up``); one that holds state the port does not carry yet
        (the arena, the async buffer) raises ``NotImplementedError``
        naming its ROADMAP item."""
        by_path, extra, step = manager.restore_items(step)
        root = tree_to(unflatten_paths(by_path, listify=False), self.device)
        for section in _UNPORTED_SECTIONS:
            if section in root or section in extra:
                raise NotImplementedError(
                    f"checkpoint section {section!r}: "
                    f"{_UNPORTED_SECTIONS[section]} is not ported yet")
        self.global_params = root["global_params"]
        self.server_state = root.get("server_state", {})
        self._stale_ref = root.get("stale_ref")
        self._down_ref = root.get("down_ref")
        self._down_ef = root.get("down_ef")
        self.client_states = {int(c): s for c, s
                              in root.get("client_states", {}).items()}
        self.local_trees = {int(c): t for c, t
                            in root.get("local_trees", {}).items()}
        self.round_idx = int(extra["round_idx"])
        r = extra["rng"]
        self.rng.set_state((r[0], np.asarray(r[1], np.uint32), int(r[2]),
                            int(r[3]), float(r[4])))
        (self.comm_log.down_bytes, self.comm_log.up_bytes,
         self.comm_log.rounds) = (int(v) for v in extra["comm"])
        self.history = list(extra["history"])
        return step

    def run(self, rounds: Optional[int] = None, log_every: int = 0,
            ckpt: Optional[Any] = None, ckpt_every: int = 1) -> List[Dict]:
        """Run ``rounds`` federated rounds (default
        ``ServerConfig.rounds``) and return the full ``history``.

        With ``ckpt`` (a ``repro_torch.checkpoint.CheckpointManager``),
        ``rounds`` is the TOTAL round target: a server restored through
        :meth:`restore_checkpoint` runs only the remaining rounds, and
        the state is checkpointed every ``ckpt_every`` completed rounds
        and at the end."""
        target = rounds or self.scfg.rounds
        if ckpt is None:
            for r in range(target):
                rec = self.run_round()
                if log_every and (r % log_every == 0):
                    print(rec)
            return self.history
        while self.round_idx < target:
            rec = self.run_round()
            if log_every and ((self.round_idx - 1) % log_every == 0):
                print(rec)
            if (self.round_idx % ckpt_every == 0
                    or self.round_idx >= target):
                self.save_checkpoint(ckpt)
        ckpt.wait()
        return self.history

    # --------------------------------------------- personalization eval
    def personalized_eval(self, eval_fn: Callable) -> List[float]:
        """Evaluate each client's merged (global + resident local) model
        with ``eval_fn(params, cid)``."""
        scores = []
        for cid in range(self.scfg.clients):
            params = self._client_full_params(cid, self._download_payload(cid))
            scores.append(float(eval_fn(params, cid)))
        return scores
