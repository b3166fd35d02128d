// Fused dequant-accumulate for the streaming FL aggregation (K7), sm_90a:
//
//   acc[l] += Σ_c coeff[c] · float(q[c, l])      acc (L,) fp32, in place
//
// over a client-stacked wire buffer q (C, L) of int8, fp16 or fp32.
// coeff folds the arrival mask, the aggregation weight and, for an int8
// {"q", "scale"} node, the client's quantizer scale (the dequant is
// linear: Σ w_c s_c q_c = Σ (w_c s_c) q_c).
//
// Replaces (TPU, Pallas):
//   K7  src/repro/kernels/agg.py:_agg_body (wrapper dequant_acc)  -> repro_dequant_acc
//
// What bounds it on an H100: bytes. It does 2 operations per wire
// element (a multiply and an add) against 1, 2 or 4 bytes read, plus
// 8 bytes of accumulator per column (read once, written once): about
// 1 operation per byte, far below the card's ≈295 operations per byte.
// The least time is (itemsize·C + 8)·L / 3.35 TB/s.
// What the design does about it:
//   * each wire element is read once, at its wire width, as 16-byte
//     vectors (16 int8, 8 fp16 or 4 fp32 per load), neighbouring
//     threads on neighbouring addresses; it is widened in registers
//     only, never written back wider;
//   * one block owns a slab of L (256 threads x one vector each) and
//     walks all C clients in order, so every column's sum is taken in
//     one fixed order: deterministic, with no atomics and no second
//     pass; four clients' loads are issued before their sums, to keep
//     bytes in flight;
//   * the C coefficients sit in shared memory (loaded 256 at a time);
//   * sums stay in fp32 registers, and acc is read once and written
//     once, in place (the reference aliases it: agg.py:120);
//   * a ragged L, and a buffer or row stride that breaks 16-byte
//     alignment (leaves are flattened views of any size), take a masked
//     scalar path inside the kernel; the host pads nothing. A
//     coefficient of 0 (a pad slot, a client that did not arrive) adds
//     an exact zero.
#include "tiles.cuh"

using namespace tiles;

namespace {

enum { Q_I8 = 0, Q_F16 = 1, Q_F32 = 2 };
constexpr int CS = 256;   // coefficients staged in shared memory at once
constexpr int UNROLL = 4; // clients whose loads are in flight together

template <typename QT>
__global__ void __launch_bounds__(NT)
dequant_acc_kernel(float* __restrict__ acc, const QT* __restrict__ q,
                   const float* __restrict__ coeff, int C, long long L, long long ldq,
                   bool vec) {
  constexpr int V = 16 / sizeof(QT);            // wire values per 16-byte vector
  __shared__ float cs[CS];
  const long long l0 = ((long long)blockIdx.x * NT + threadIdx.x) * V;
  const bool full = vec && l0 + V <= L;         // this thread's vector is whole
  float sum[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = 0.f;

  for (int cb = 0; cb < C; cb += CS) {
    const int nc = min(CS, C - cb);
    __syncthreads();                            // the previous stage is read
    for (int i = threadIdx.x; i < nc; i += NT) cs[i] = coeff[cb + i];
    __syncthreads();
    if (full) {
      int k = 0;
      for (; k + UNROLL <= nc; k += UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = load16(q + (cb + k + u) * ldq + l0);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float w = cs[k + u];
#pragma unroll
          for (int e = 0; e < V; ++e) sum[e] += w * elem<QT>(v[u], e);
        }
      }
      for (; k < nc; ++k) {
        const uint4 v = load16(q + (cb + k) * ldq + l0);
        const float w = cs[k];
#pragma unroll
        for (int e = 0; e < V; ++e) sum[e] += w * elem<QT>(v, e);
      }
    } else if (l0 < L) {                         // masked scalar path
      for (int k = 0; k < nc; ++k) {
        const QT* row = q + (cb + k) * ldq;
        const float w = cs[k];
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (l0 + e < L) sum[e] += w * to_f(row[l0 + e]);
      }
    }
  }
  if (l0 >= L) return;
  if (full && aligned16(acc)) {                  // acc as float4s
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      float4* p = reinterpret_cast<float4*>(acc + l0 + e);
      float4 a = *p;
      a.x += sum[e];
      a.y += sum[e + 1];
      a.z += sum[e + 2];
      a.w += sum[e + 3];
      *p = a;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (l0 + e < L) acc[l0 + e] += sum[e];
}

template <typename QT>
int launch(void* acc, const void* q, const void* coeff, int C, long long L, long long ldq,
           cudaStream_t s) {
  constexpr int V = 16 / sizeof(QT);
  // the vector path needs every row's start 16-byte aligned
  const bool vec = (reinterpret_cast<uintptr_t>(q) & 15u) == 0 &&
                   (ldq * (long long)sizeof(QT)) % 16 == 0;
  const long long blocks = (L + (long long)NT * V - 1) / ((long long)NT * V);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dequant_acc_kernel<QT><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<float*>(acc), static_cast<const QT*>(q), static_cast<const float*>(coeff),
      C, L, ldq, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc (L,) fp32 += coeff (C,) fp32 · float(q): row c of q starts at
// q + c·ldq elements (ldq >= L; ldq = L for a contiguous (C, L) stack).
// q_dtype: 0 int8 | 1 fp16 | 2 fp32. acc is updated in place. Returns
// the launch's cudaError_t (0 on success).
int repro_dequant_acc(void* acc, const void* q, const void* coeff, int C, long long L,
                      long long ldq, int q_dtype, void* stream) {
  if (C <= 0 || L <= 0) return 0;
  if (ldq < L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case Q_I8: return launch<int8_t>(acc, q, coeff, C, L, ldq, s);
    case Q_F16: return launch<__half>(acc, q, coeff, C, L, ldq, s);
    case Q_F32: return launch<float>(acc, q, coeff, C, L, ldq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
