"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do). With no card and no explicit CPU request they
raise: a run that asked for the card never quietly carries on on the
host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises:
        RuntimeError: a CUDA device was asked for (explicitly or by
            default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
