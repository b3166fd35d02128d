"""Launch configuration of the port's CUDA kernels on an H100.

The TPU tile table (``repro/kernels/blocks.py``) sized VMEM tiles for a
128x128 matrix unit and a sequential grid; none of it carries over.
The Hopper kernels' launch configuration lives in one place, the shared
tile code ``csrc/tiles.cuh``, which picks it at each launch:

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
