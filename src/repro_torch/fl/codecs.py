"""Up/down-link codecs of the FL wire (PyTorch), the counterpart of the
reference's ``repro/fl/codecs.py`` — for now the identity codec only.

``make_codec`` accepts the reference's identity specs (``""``, ``fp32``,
``none``, ``identity``). Every other stage (delta, topk, lowrank, int8,
fp16) raises ``NotImplementedError``: those stages, their error
feedback and the injected int8 rounding noise are ROADMAP A7.

Byte accounting is exact and data-independent: ``wire_bytes`` sums each
leaf's element count times its itemsize, the integers the reference's
identity codec charges.

The encoded-form aggregation hooks of the streaming engine
(``encode_for_agg``, ``agg_linear``, ``agg_finalize``; the reference's
``codecs.py:278-315``) are here for the identity codec: its wire is the
payload itself, linear, with no delta reference to add back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.tree import tree_bytes

_IDENTITY_SPECS = ("", "fp32", "none", "identity")


@dataclass(frozen=True)
class Codec:
    """A wire codec; ``stages`` is empty for the identity codec, the only
    one ported so far."""

    spec: str
    stages: Tuple[Any, ...] = ()

    @property
    def is_identity(self) -> bool:
        return not self.stages

    @property
    def has_ef(self) -> bool:
        """Whether the codec keeps error feedback (top-k only)."""
        return False

    @property
    def has_delta(self) -> bool:
        """Whether the codec sends differences against a reference."""
        return False

    def encode_decode(self, payload: Any, *, ref: Any = None, ef: Any = None,
                      key: Optional[Any] = None) -> Tuple[Any, Optional[Any]]:
        """One simulated wire round trip: ``(decoded, new_ef)``; the
        identity codec hands the payload back untouched."""
        return payload, ef

    @property
    def agg_linear(self) -> bool:
        """Whether wires can be weighted-summed without a per-client
        decode (the identity wire is the payload: yes)."""
        return True

    def encode_for_agg(self, payload: Any, *, ref: Any = None,
                       ef: Any = None, key: Optional[Any] = None
                       ) -> Tuple[Any, Optional[Any]]:
        """Encode for the streaming (encoded-form) aggregator:
        ``(agg_wire, new_ef)`` with decode(wire) = linear(agg_wire); the
        identity codec hands the payload back."""
        return payload, ef

    def agg_finalize(self, mean: Any, *, ref: Any = None) -> Any:
        """Map the weighted mean of ``encode_for_agg`` wires back to
        payload space (a delta codec adds its reference back; the
        identity codec has none)."""
        return mean

    def wire_bytes(self, payload: Any) -> int:
        """Exact wire size of ``payload``, from leaf shapes alone."""
        return tree_bytes(payload)


def make_codec(spec: Optional[str]) -> Codec:
    """Parse a codec spec; only the identity codec is ported."""
    raw = (spec or "").strip()
    if raw in _IDENTITY_SPECS:
        return Codec(spec="fp32")
    raise NotImplementedError(
        f"codec {raw!r}: only the identity codec (''/fp32/none/identity) "
        "is ported; the delta, topk, lowrank, int8 and fp16 stages are "
        "ROADMAP A7")
