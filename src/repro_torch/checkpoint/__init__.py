"""Checkpoints in the reference's on-disk format (``manager``), with the
manifest's own MessagePack codec (``manifest``)."""
from repro_torch.checkpoint.manager import CheckpointManager, unflatten_paths

__all__ = ["CheckpointManager", "unflatten_paths"]
