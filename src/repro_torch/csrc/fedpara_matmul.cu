// Fused FedPara forward matmul for sm_90a:
//   y = x · (f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ))
// for the three paper variants (apply_variant): fedpara (identity),
// fedpara_tanh (tanh ⊙ tanh) and pfedpara (the "+1 switch" on f2).
//
// Replaces (TPU, Pallas):
//   K1  src/repro/kernels/fedpara_matmul.py:_kernel            -> repro_fedpara_matmul
//   K2  src/repro/kernels/fedpara_matmul.py:_kernel_batched    -> repro_fedpara_matmul
//   K3  src/repro/kernels/fedpara_grad.py:_dx_body             -> repro_fedpara_dx
//       (the same kernel on the transposed weight; see repro_fedpara_dx),
//       its 2-D form and its lead=True form with a client axis
//
// K2 is K1 with a client index on grid z: client c reads x, the four
// factors and y at its own offsets (per-client strides of a contiguous
// (C, rows, m) / (C, m, r) / (C, n, r) / (C, rows, n) stack), so all C
// clients of a batched FL step run in one launch per layer, as the
// reference's batched grid does. K1 is the C = 1 case of the same
// kernel. Every client has its own factors, so the compose is paid C
// times: a client-stacked launch does C times K1's compose work on
// rows/C rows each. At the FL MLP's shapes (C = 8 clients of 64 rows)
// a layer gives C x 8 blocks instead of 8.
//
// What bounds it on an H100: operations. Each (32 x 32) W tile costs
// two rank-r products, 4·r FLOPs per weight (r = 160, 70, 211 at
// qwen3-8b's widths), against 2 FLOPs per weight and activation row for
// the contraction. At a 512-row prefill the compose is about as much
// work as the matmul; the bytes (fp32 factors, bf16 activations) are
// small beside either.
// What the design does about it:
//   * the TPU kernel recomposed each W tile for every row block of its
//     grid; here one block holds up to 512 rows and composes each tile
//     once for all of them (tiles.cuh), so a full-width prefill pays
//     the compose once per tile;
//   * the rank loop prefetches factor chunk c+1 into registers while
//     chunk c is accumulated, so a step waits on memory once, not once
//     per chunk;
//   * f1, f2 and the Hadamard product are applied in registers, and the
//     tile is cast to the activation dtype before the contraction,
//     exactly as fedpara_matmul.py:63-68 does;
//   * W never exists in device memory.
// Not yet done (later work): tensor-core compose and contraction.
#include "tiles.cuh"

using namespace tiles;

namespace {

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };

template <class S, typename XT, int KIND>
struct FedParaTile {
  static constexpr bool kHasW = false;
  static constexpr int kChunks = 2;
  using WT = int8_t;  // no cache: the tile is composed from factors only
  const float* __restrict__ x1;
  const float* __restrict__ y1;
  const float* __restrict__ x2;
  const float* __restrict__ y2;
  int m, n, r;
  __device__ __forceinline__ float prep(float v) const { return v; }
  __device__ __forceinline__ void finish(int k0, int n0, float (*ws)[BN],
                                         FactorChunk<S>* ch) const {
    float w[2][S::CJ];
    const float* const xs[2] = {x1, x2};
    const float* const ys[2] = {y1, y2};
    compose<S, 2>(xs, ys, m, n, r, k0, n0, ch, w);
    const int c = threadIdx.x % BN, kr = threadIdx.x / BN;
#pragma unroll
    for (int j = 0; j < S::CJ; ++j) {
      const int kk = kr + j * (NT / BN);
      float a = w[0][j], b = w[1][j];
      if (KIND == K_TANH) {
        a = tanhf(a);
        b = tanhf(b);
      }
      if (KIND == K_PFEDPARA) b += 1.f;
      const bool in = (k0 + kk < m) && (n0 + c < n);
      ws[kk][c] = in ? round_to<XT>(a * b) : 0.f;
    }
  }
};

template <class S, typename XT, int KIND>
__global__ void __launch_bounds__(NT)
fedpara_kernel(const XT* __restrict__ x, const float* __restrict__ x1,
               const float* __restrict__ y1, const float* __restrict__ x2,
               const float* __restrict__ y2, XT* __restrict__ y, int rows, int m, int n,
               int r) {
  extern __shared__ __align__(16) float smem[];
  const size_t c = blockIdx.z;   // client: every operand at its own slab
  const size_t xs = (size_t)m * r, ys = (size_t)n * r;
  const FedParaTile<S, XT, KIND> tile{x1 + c * xs, y1 + c * ys, x2 + c * xs, y2 + c * ys,
                                      m, n, r};
  tiled_matmul<S, XT>(x + c * rows * m, y + c * rows * n, nullptr, rows, m, n, tile, smem);
}

template <class S, typename XT, int KIND>
int launch_shape(int clients, const void* x, const void* x1, const void* y1,
                 const void* x2, const void* y2, void* y, int rows, int m, int n, int r,
                 cudaStream_t s) {
  auto k = fedpara_kernel<S, XT, KIND>;
  cudaError_t err = allow_smem(k, smem_bytes<S>(S::MAXR, 2));
  if (err != cudaSuccess) return (int)err;
  k<<<grid_for<S>(rows, n, clients), NT, smem_bytes<S>(rows, 2), s>>>(
      static_cast<const XT*>(x), static_cast<const float*>(x1),
      static_cast<const float*>(y1), static_cast<const float*>(x2),
      static_cast<const float*>(y2), static_cast<XT*>(y), rows, m, n, r);
  return (int)cudaGetLastError();
}

template <typename XT, int KIND>
int launch(int clients, const void* x, const void* x1, const void* y1, const void* x2,
           const void* y2, void* y, int rows, int m, int n, int r, cudaStream_t s) {
  if (rows <= Skinny::MAXR)
    return launch_shape<Skinny, XT, KIND>(clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
  return launch_shape<Wide, XT, KIND>(clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
}

template <typename XT>
int launch_kind(int kind, int clients, const void* x, const void* x1, const void* y1,
                const void* x2, const void* y2, void* y, int rows, int m, int n, int r,
                cudaStream_t s) {
  switch (kind) {
    case K_FEDPARA:
      return launch<XT, K_FEDPARA>(clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
    case K_TANH: return launch<XT, K_TANH>(clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
    case K_PFEDPARA:
      return launch<XT, K_PFEDPARA>(clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1 and K2: for each client c < clients, y[c] (rows, n) = x[c] (rows,
// m) · (f1(X1[c] Y1[c]ᵀ) ⊙ f2(X2[c] Y2[c]ᵀ)); x (clients, rows, m), X1,
// X2 (clients, m, r) and Y1, Y2 (clients, n, r) fp32, all contiguous;
// clients = 1 is K1's 2-D call. kind: 0 fedpara | 1 fedpara_tanh |
// 2 pfedpara. x_dtype: X_F32 | X_BF16 (y has x's dtype). Returns the
// launch's cudaError_t (0 on success).
int repro_fedpara_matmul(const void* x, const void* x1, const void* y1, const void* x2,
                         const void* y2, void* y, int clients, int rows, int m, int n, int r,
                         int kind, int x_dtype, void* stream) {
  if (clients <= 0 || rows <= 0 || n <= 0) return 0;
  if (clients > 65535) return (int)cudaErrorInvalidValue;   // grid z
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == X_F32)
    return launch_kind<float>(kind, clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
  if (x_dtype == X_BF16)
    return launch_kind<__nv_bfloat16>(kind, clients, x, x1, y1, x2, y2, y, rows, m, n, r, s);
  return (int)cudaErrorInvalidValue;
}

// K3, the input gradient of the fused matmul (replaces
// src/repro/kernels/fedpara_grad.py:_dx_body, both its forms):
//   dx[c] (rows, m) = dy[c] (rows, n) · W[c]ᵀ,  Wᵀ = f1(Y1 X1ᵀ) ⊙ f2(Y2 X2ᵀ),
// because f1 and f2 act elementwise and so commute with the transpose.
// dy takes x's place and (Y1, X1, Y2, X2) take (X1, Y1, X2, Y2)'s: the
// kernel above composes each Wᵀ tile on chip, casts it to dy's dtype
// (as _dx_body casts its tile) and contracts it; W is never stored.
// clients = 1 is the 2-D form, more is the lead=True form with dy
// (clients, rows, n). dx has dy's dtype. Returns the launch's
// cudaError_t.
int repro_fedpara_dx(const void* dy, const void* x1, const void* y1, const void* x2,
                     const void* y2, void* dx, int clients, int rows, int m, int n, int r,
                     int kind, int x_dtype, void* stream) {
  return repro_fedpara_matmul(dy, y1, x1, y2, x2, dx, clients, rows, n, m, r, kind, x_dtype,
                              stream);
}

}  // extern "C"
