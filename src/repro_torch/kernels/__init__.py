"""Hand-written CUDA kernels for the serve path, their plain PyTorch
versions (``ref``) and the dispatch between them (``ops``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
