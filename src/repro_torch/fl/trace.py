"""Per-client data seeds of a round (numpy), a copy of the reference's
``repro/fl/trace.py::spawn_seeds``. ``FleetTrace`` (trace-driven
sampling) is not ported yet (ROADMAP A4)."""
from __future__ import annotations

import numpy as np

# domain-separation tag mixed into every SeedSequence entropy tuple (the
# reference's value, so the seeds are the reference's)
_TRACE_TAG = 0x5EEDF1EE


def spawn_seeds(seed: int, round_idx: int, n: int) -> np.ndarray:
    """``n`` collision-free 64-bit data seeds for one round: one
    ``SeedSequence`` keyed on ``(seed, round)``, spawned into ``n``
    children, one ``uint64`` word each."""
    root = np.random.SeedSequence((int(seed), _TRACE_TAG, int(round_idx)))
    return np.array(
        [child.generate_state(1, np.uint64)[0] for child in root.spawn(n)],
        dtype=np.uint64)
