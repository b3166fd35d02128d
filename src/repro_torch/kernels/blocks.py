"""Launch configuration of the port's CUDA kernels on an H100.

The TPU tile table (``repro/kernels/blocks.py``) sized VMEM tiles for a
128x128 matrix unit and a sequential grid; none of it carries over.
The Hopper kernels' launch configuration lives in their CUDA sources,
which pick it at each launch. The fused FedPara matmul (K1, K2, K3 and
K3 with a client axis, ``csrc/fedpara_matmul.cu``) runs on the tensor
cores with its own tiles: 512 threads (8 compose warps, 8 contraction
warps), 32 output columns and up to 512 (bf16) or 128 (fp32)
activation rows per block, steps of 64 rows of m, rank chunks of 32 in
a three-stage ring; grid = (ceil(n / 32), row blocks x splits of m,
clients), the splits chosen by ``repro_fedpara_splits`` to fill the
card. The other kernels share the
tile code ``csrc/tiles.cuh``:

* every block has 256 threads (``NT``) and owns 32 output columns
  (``BN``);
* ``Wide`` (rows > 32, prefill): up to 512 activation rows per block,
  contraction steps of 32, so a 512-row prefill builds each W tile
  once;
* ``Skinny`` (rows <= 32, decode): up to 32 rows, steps of 128, split
  over the block's 8 warps;
* the rank-r compose walks rank chunks of 32 (``RC``);
* grid = (ceil(n / 32), ceil(rows / max rows), users);
* the compose kernels (K5/K6, ``csrc/fedpara_compose.cu``) have no
  activation rows: a block composes a (128 x 32) tile of W, the Skinny
  shape's step, on grid (ceil(n / 32), ceil(m / 128), layers).

This module holds no code: the wrappers pass shapes, and the C entry
points choose the block shape, grid and shared memory.
"""
