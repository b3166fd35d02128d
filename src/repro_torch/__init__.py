"""FedPara on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors the reference's subpackages (``configs``, ``core``,
``kernels``, ``nn``, ``data``, ``fl``, ``serve``, ``launch``) and imports neither
JAX nor the reference package. Its hand-written CUDA kernels live in
``csrc/`` and build at first use (``repro_torch.kernels.build``).
"""
