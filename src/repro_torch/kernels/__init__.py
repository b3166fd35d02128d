"""Hand-written CUDA kernels for the serve and training paths, their
plain PyTorch versions (``ref``), the dispatch between them (``ops``)
and the autograd wiring of the fused matmul (``fedpara_grad``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
