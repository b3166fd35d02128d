// FedPara compose for sm_90a: the dense weight itself,
//   W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ),
// for the three paper variants (fedpara, fedpara_tanh, pfedpara's "+1
// switch" on f2), written to device memory in fp32, fp16 or bf16. The
// serving path pre-composes W once per layer into its int8 or fp16
// weight cache (serve/cache.py).
//
// Replaces (TPU, Pallas):
//   K5  src/repro/kernels/fedpara_compose.py:_kernel           -> repro_fedpara_compose
//   K6  src/repro/kernels/fedpara_compose.py:_kernel_batched   -> repro_fedpara_compose
//
// One block (256 threads) owns a (128 x 32) tile of W and composes it
// with K1's rank-r tile compose (tiles.cuh `compose`: both factor pairs
// at once, rank chunks of RC = 32 staged in shared memory, the next
// chunk prefetched into registers while this one is accumulated; the
// Skinny shape of K1's launch table, BK = 128). The leading axis (the
// layers of a stacked node, K6) is grid z and every operand is read at
// its own slab, so K5 is K6's lead = 1 case, as K1 is K2's. f1, f2 and
// the product are applied to the fp32 sums in registers, and each
// element is rounded once, at its store, to the requested type (the
// reference composes in fp32 and casts, fedpara_compose.py:39). Ragged
// m, n and r are masked in the kernel (no padded copies); every element
// of W is written exactly once, so there are no atomics.
//
// What bounds it on an H100: operations. The two rank-r products cost
// 4·m·n·r fp32 FLOPs on the CUDA cores (67 TFLOP/s); one qwen3-8b layer
// at gamma 0.1 (ranks 160 / 70 / 211 for wq,wo / wk,wv / gate,up,down)
// is 1.51e11 FLOPs, 2.26 ms, while its 193M output elements take
// 0.23 ms to write in fp32 and 0.12 ms in fp16, a tenth of that.
// What this first version does about it: little. The inner loop issues
// one shared-memory load per FMA (the X value is a warp broadcast), so
// the load pipe, not the FMA pipe, sets its pace. Register blocking,
// tensor cores (TF32/bf16 compose, if the tolerance allows) and TMA
// are later work.
#include "tiles.cuh"

using namespace tiles;

namespace {

using CS = Skinny;   // BK = 128 rows of W per block, BN = 32 columns

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };
enum { O_F32 = 0, O_F16 = 1, O_BF16 = 2 };   // output dtype codes

template <typename OT> __device__ __forceinline__ OT store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ __half store_as<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int KIND, typename OT>
__global__ void __launch_bounds__(NT)
compose_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
               const float* __restrict__ x2, const float* __restrict__ y2,
               OT* __restrict__ w, int m, int n, int r) {
  __shared__ __align__(16) FactorChunk<CS> ch[2];
  const size_t c = blockIdx.z;   // slab of the leading axis
  const size_t xs = (size_t)m * r, ys = (size_t)n * r;
  const float* const X[2] = {x1 + c * xs, x2 + c * xs};
  const float* const Y[2] = {y1 + c * ys, y2 + c * ys};
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * CS::BK;
  float acc[2][CS::CJ];
  compose<CS, 2>(X, Y, m, n, r, k0, n0, ch, acc);   // syncs inside

  const int col = n0 + threadIdx.x % BN, kr = threadIdx.x / BN;
  if (col >= n) return;
  OT* out = w + c * (size_t)m * n;
#pragma unroll
  for (int j = 0; j < CS::CJ; ++j) {
    const int row = k0 + kr + j * (NT / BN);
    if (row >= m) break;
    float a = acc[0][j], b = acc[1][j];
    if (KIND == K_TANH) {
      a = tanhf(a);
      b = tanhf(b);
    }
    if (KIND == K_PFEDPARA) b += 1.f;
    out[(size_t)row * n + col] = store_as<OT>(a * b);
  }
}

template <int KIND, typename OT>
int launch(int lead, const void* x1, const void* y1, const void* x2, const void* y2,
           void* w, int m, int n, int r, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + CS::BK - 1) / CS::BK, lead);
  compose_kernel<KIND, OT><<<grid, NT, 0, s>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1),
      static_cast<const float*>(x2), static_cast<const float*>(y2), static_cast<OT*>(w), m,
      n, r);
  return (int)cudaGetLastError();
}

template <typename OT>
int launch_kind(int kind, int lead, const void* x1, const void* y1, const void* x2,
                const void* y2, void* w, int m, int n, int r, cudaStream_t s) {
  switch (kind) {
    case K_FEDPARA: return launch<K_FEDPARA, OT>(lead, x1, y1, x2, y2, w, m, n, r, s);
    case K_TANH: return launch<K_TANH, OT>(lead, x1, y1, x2, y2, w, m, n, r, s);
    case K_PFEDPARA: return launch<K_PFEDPARA, OT>(lead, x1, y1, x2, y2, w, m, n, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K5 and K6: for each slab c < lead, W[c] (m, n) = f1(X1[c] Y1[c]ᵀ) ⊙
// f2(X2[c] Y2[c]ᵀ); X1, X2 (lead, m, r) and Y1, Y2 (lead, n, r) fp32,
// W (lead, m, n), all contiguous; lead = 1 is K5's 2-D call. kind:
// 0 fedpara | 1 fedpara_tanh | 2 pfedpara. out_dtype: 0 fp32 | 1 fp16 |
// 2 bf16. Returns the launch's cudaError_t (0 on success).
int repro_fedpara_compose(const void* x1, const void* y1, const void* x2, const void* y2,
                          void* w, int lead, int m, int n, int r, int kind, int out_dtype,
                          void* stream) {
  if (lead <= 0 || m <= 0 || n <= 0) return 0;
  if (lead > 65535 || (m + CS::BK - 1) / CS::BK > 65535 || r < 0)   // grid z, y
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case O_F32: return launch_kind<float>(kind, lead, x1, y1, x2, y2, w, m, n, r, s);
    case O_F16: return launch_kind<__half>(kind, lead, x1, y1, x2, y2, w, m, n, r, s);
    case O_BF16:
      return launch_kind<__nv_bfloat16>(kind, lead, x1, y1, x2, y2, w, m, n, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
