// Serve-path kernels: the int8/fp16 weight-cache matmul and the pFedPara
// cache + residual matmul (single- and many-user), for sm_90a.
//
// Replaces (TPU, Pallas):
//   K8  src/repro/kernels/serve_matmul.py:_w8_kernel           -> repro_w8_matmul
//   K9  src/repro/kernels/serve_matmul.py:_resid_kernel        -> repro_cache_residual (U = 1)
//   K10 src/repro/kernels/serve_matmul.py:_resid_kernel_users  -> repro_cache_residual
//
// What bounds them on an H100:
//   * K8 at decode (4 rows) is bound by the bytes of the cache: every
//     int8 weight is read once and used for 4 rows (a 4096 x 12288
//     cache is 50 MB, about 15 us at 3.35 TB/s). At prefill (512 rows)
//     each weight feeds 512 FMAs and the kernel is bound by operations.
//   * K9/K10 add a rank-r residual compose per cache tile: 2·r FLOPs
//     per weight and user, which at r = 70..211 outweighs the 8 FLOPs
//     per weight of a 4-row decode; they are bound by operations.
// What the design does about it:
//   * the cache tile enters shared memory at its stored width (1 byte
//     per int8 weight) and is widened there, never in device memory;
//   * the per-column scale is applied once, to the fp32 accumulator
//     (it commutes with the row sum, serve_matmul.py:18-23);
//   * one block holds up to 512 rows, so a prefill reads each cache
//     tile and composes each residual tile once per 512 rows;
//   * the user index is grid axis z and indexes x, X2, Y2 and y; the
//     shared cache is indexed without it.
//   * at decode (<= 32 rows) a block steps through 128 contraction rows
//     at a time with 16-byte cache loads, and blocks are small enough
//     that many stay resident per SM to keep bytes in flight.
// Not yet done (later work): split-K or persistent blocks for the
// narrow (n = 1024) projections, TMA/cp.async pipelines, tensor cores.
#include "tiles.cuh"

using namespace tiles;

namespace {

template <class S, typename XT, typename WT_>
struct W8Tile {
  static constexpr bool kHasW = true;
  static constexpr int kChunks = 0;
  using WT = WT_;
  const WT* __restrict__ w;
  __device__ __forceinline__ float prep(float v) const { return round_to<XT>(v); }
  __device__ __forceinline__ void finish(int, int, float (*)[BN], FactorChunk<S>*) const {}
};

template <class S, typename XT, typename WT_>
struct ResidTile {
  static constexpr bool kHasW = true;
  static constexpr int kChunks = 1;
  using WT = WT_;
  const WT* __restrict__ w;
  const float* __restrict__ x2;
  const float* __restrict__ y2;
  int m, n, r;
  // the cache value enters ws exactly; the Hadamard product rounds
  __device__ __forceinline__ float prep(float v) const { return v; }
  __device__ __forceinline__ void finish(int k0, int n0, float (*ws)[BN],
                                         FactorChunk<S>* ch) const {
    float racc[1][S::CJ];
    const float* const xs[1] = {x2};
    const float* const ys[1] = {y2};
    compose<S, 1>(xs, ys, m, n, r, k0, n0, ch, racc);
    const int c = threadIdx.x % BN, kr = threadIdx.x / BN;
#pragma unroll
    for (int j = 0; j < S::CJ; ++j) {
      const int kk = kr + j * (NT / BN);
      ws[kk][c] = round_to<XT>(ws[kk][c] * (racc[0][j] + 1.f));
    }
  }
};

template <class S, typename XT, typename WT>
__global__ void __launch_bounds__(NT)
w8_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
          const float* __restrict__ scale, XT* __restrict__ y, int rows, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const W8Tile<S, XT, WT> tile{w};
  tiled_matmul<S, XT>(x, y, scale, rows, m, n, tile, smem);
}

// x2_us / y2_us: element strides between users' factor slabs (each slab
// is a contiguous (m, r) / (n, r) matrix), so the engine's gathered
// cohort is read in place whatever its leading layout.
template <class S, typename XT, typename WT>
__global__ void __launch_bounds__(NT)
resid_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ x2,
             const float* __restrict__ y2, XT* __restrict__ y, int t, int m, int n, int r,
             long long x2_us, long long y2_us) {
  extern __shared__ __align__(16) float smem[];
  const size_t u = blockIdx.z;
  const ResidTile<S, XT, WT> tile{w, x2 + u * x2_us, y2 + u * y2_us, m, n, r};
  tiled_matmul<S, XT>(x + u * t * m, y + u * t * n, scale, t, m, n, tile, smem);
}

template <class S, typename XT, typename WT>
int launch_w8_shape(const void* x, const void* w, const void* scale, void* y, int rows,
                    int m, int n, cudaStream_t s) {
  auto k = w8_kernel<S, XT, WT>;
  cudaError_t err = allow_smem(k, smem_bytes<S>(S::MAXR, 0));
  if (err != cudaSuccess) return (int)err;
  k<<<grid_for<S>(rows, n, 1), NT, smem_bytes<S>(rows, 0), s>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(scale), static_cast<XT*>(y), rows, m, n);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int launch_w8(const void* x, const void* w, const void* scale, void* y, int rows, int m,
              int n, cudaStream_t s) {
  if (rows <= Skinny::MAXR) return launch_w8_shape<Skinny, XT, WT>(x, w, scale, y, rows, m, n, s);
  return launch_w8_shape<Wide, XT, WT>(x, w, scale, y, rows, m, n, s);
}

template <class S, typename XT, typename WT>
int launch_resid_shape(const void* x, const void* w, const void* scale, const void* x2,
                       const void* y2, void* y, int users, int t, int m, int n, int r,
                       long long x2_us, long long y2_us, cudaStream_t s) {
  auto k = resid_kernel<S, XT, WT>;
  cudaError_t err = allow_smem(k, smem_bytes<S>(S::MAXR, 1));
  if (err != cudaSuccess) return (int)err;
  k<<<grid_for<S>(t, n, users), NT, smem_bytes<S>(t, 1), s>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(x2),
      static_cast<const float*>(y2), static_cast<XT*>(y), t, m, n, r, x2_us, y2_us);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int launch_resid(const void* x, const void* w, const void* scale, const void* x2,
                 const void* y2, void* y, int users, int t, int m, int n, int r,
                 long long x2_us, long long y2_us, cudaStream_t s) {
  if (t <= Skinny::MAXR)
    return launch_resid_shape<Skinny, XT, WT>(x, w, scale, x2, y2, y, users, t, m, n, r,
                                              x2_us, y2_us, s);
  return launch_resid_shape<Wide, XT, WT>(x, w, scale, x2, y2, y, users, t, m, n, r, x2_us,
                                          y2_us, s);
}

}  // namespace

extern "C" {

// y (rows, n) = (x (rows, m) · W (m, n)) · scale (n); scale may be null.
// x_dtype: X_F32 | X_BF16 (y has x's dtype); w_dtype: W_I8 | W_F16.
// Returns the cudaError_t of the launch (0 on success).
int repro_w8_matmul(const void* x, const void* w, const void* scale, void* y, int rows,
                    int m, int n, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == X_F32 && w_dtype == W_I8) return launch_w8<float, int8_t>(x, w, scale, y, rows, m, n, s);
  if (x_dtype == X_F32 && w_dtype == W_F16) return launch_w8<float, __half>(x, w, scale, y, rows, m, n, s);
  if (x_dtype == X_BF16 && w_dtype == W_I8) return launch_w8<__nv_bfloat16, int8_t>(x, w, scale, y, rows, m, n, s);
  if (x_dtype == X_BF16 && w_dtype == W_F16) return launch_w8<__nv_bfloat16, __half>(x, w, scale, y, rows, m, n, s);
  return (int)cudaErrorInvalidValue;
}

// y (U, t, n) = x (U, t, m) · ((W·scale) ⊙ (X2ᵤ Y2ᵤᵀ + 1)) per user u,
// with fp32 factor slabs X2ᵤ (m, r) at x2 + u·x2_us and Y2ᵤ (n, r) at
// y2 + u·y2_us, and one shared cache W (m, n).
int repro_cache_residual(const void* x, const void* w, const void* scale, const void* x2,
                         const void* y2, void* y, int users, int t, int m, int n, int r,
                         long long x2_us, long long y2_us, int x_dtype, int w_dtype,
                         void* stream) {
  if (users <= 0 || t <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == X_F32 && w_dtype == W_I8)
    return launch_resid<float, int8_t>(x, w, scale, x2, y2, y, users, t, m, n, r, x2_us, y2_us, s);
  if (x_dtype == X_F32 && w_dtype == W_F16)
    return launch_resid<float, __half>(x, w, scale, x2, y2, y, users, t, m, n, r, x2_us, y2_us, s);
  if (x_dtype == X_BF16 && w_dtype == W_I8)
    return launch_resid<__nv_bfloat16, int8_t>(x, w, scale, x2, y2, y, users, t, m, n, r, x2_us, y2_us, s);
  if (x_dtype == X_BF16 && w_dtype == W_F16)
    return launch_resid<__nv_bfloat16, __half>(x, w, scale, x2, y2, y, users, t, m, n, r, x2_us, y2_us, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
