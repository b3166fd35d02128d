"""Launch configuration of the port's CUDA kernels on an H100.

The TPU tile table (``repro/kernels/blocks.py``) sized VMEM tiles for a
128x128 matrix unit and a sequential grid; none of it carries over.
The Hopper kernels' launch configuration lives in their CUDA sources,
which pick it at each launch:

* the fused low-rank matmul (``csrc/fused.cuh``) runs on the tensor
  cores: 512 threads (8 compose warps, 8 contraction warps), 32 output
  columns per block, steps of 64 rows of m, rank chunks of 32 in a
  three-stage ring; grid = (ceil(n / 32), row blocks x splits of m,
  clients or users). K1, K2, K3 and K3 with a client axis
  (``csrc/fedpara_matmul.cu``, two rank products a tile) take up to 512
  (bf16) or 128 (fp32) activation rows per block; K9/K10
  (``csrc/serve_matmul.cu``, one rank product against the shared cache)
  also take 64 rows per block at decode widths (rows <= 64 per user),
  two blocks per SM. The splits of m are chosen to fill the card, and a
  second pass sums them in a fixed order;
* K8 at prefill widths (rows > 32, ``csrc/serve_matmul.cu``) is a
  tensor-core GEMM of 256 threads (8 warps, 2 x 4) over 128 rows x 256
  columns (bf16) or 128 x 128 (fp32) per block, steps of 64 rows of m
  in a ring of 3-4 shared-memory stages; grid = (ceil(n / columns),
  row blocks x splits of m);
* the CUDA-core kernels share ``csrc/tiles.cuh``: every block has 256
  threads (``NT``) and owns 32 output columns (``BN``); K8 at decode
  (rows <= 32) takes up to 32 rows in steps of 128 rows of m, split over
  the block's 8 warps, grid = (ceil(n / 32), ceil(rows / 32)); the
  rank-r tile compose walks rank chunks of 32 (``RC``): the compose
  kernels K5/K6 (``csrc/fedpara_compose.cu``) compose a (128 x 32) tile
  of W per block on grid (ceil(n / 32), ceil(m / 128), layers), and K4
  (``csrc/fedpara_grad.cu``) 32 x 32 tiles.

This module holds no code: the wrappers pass shapes, and the C entry
points choose the block shape, grid and shared memory.
"""
