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
* K8 at decode widths (rows <= 32, ``csrc/serve_matmul.cu``) streams the
  cache: 256 threads (8 warps) over 128 columns and up to 16 rows (8 for
  fp32 activations) per block, steps of 16 rows of m per warp through a
  3-6 stage cp.async ring that each thread fills and reads itself, x as
  the MMA's 8-column operand; grid = (ceil(n / 128), row blocks x
  splits of m), the splits chosen for two blocks per SM and summed in
  the same launch by the last block of each output tile;
* K4 (``csrc/fedpara_grad.cu``, both forms) runs 512 threads (16 warps)
  over 32 own rows (16 when the rank is above 256) per block, sweeping
  the other axis in steps of 32 columns: dW on the tensor cores from a
  2-3 stage ring of batch chunks, the rank-r composes and contractions
  in 3xTF32; grid = (ceil(P / rows), splits of the sweep, clients).
  Above rank 336 the factors are read from global memory rather than
  staged, and grid y also splits the output's rank into blocks of 512;
* the compose kernels K5/K6 (``csrc/fedpara_compose.cu``) run on the
  tensor cores (``wgmma`` m64n128k8 in 3xTF32): one persistent block of
  384 threads per SM (two warpgroups that copy and compose 64 rows each,
  one that splits Y into TF32 halves) walks every (layer, 128 x 128 tile
  of W) of the launch; grid = min(tiles, SMs). Rank chunks of 32 stream
  through a four-stage ring of shared memory (226,384 bytes a block), so
  any rank runs.

This module holds no code: the wrappers pass shapes, and the C entry
points choose the block shape, grid and shared memory.
"""
