// Shared CUDA-core tile machinery for sm_90a: the rank-r tile compose
// and K8's decode-width matmul.
//
//   * `compose` builds (X Y^T) on a (BK x BN) tile for one or two factor
//     pairs in fp32 on the CUDA cores: rank chunks of RC = 32 staged in
//     shared memory, the next chunk prefetched into registers while this
//     one is accumulated. The compose kernels K5/K6 (fedpara_compose.cu,
//     Skinny: 128 x 32 tiles) and the factor gradients K4
//     (fedpara_grad.cu, Wide: 32 x 32 tiles) use it.
//   * `tiled_matmul` is K8 at decode width (serve_matmul.cu, rows <= 32):
//     y = x · widen(W) (· s). Bound by the cache's bytes, not its
//     operations: a block (256 threads) owns BN = 32 output columns and
//     up to 32 rows and walks m in steps of BK = 128 rows; each step
//     issues all of its global loads as 16-byte vectors (a masked scalar
//     path where the shapes do not allow them), prefetches the next
//     step's x and cache tiles into registers during this step's work,
//     widens the cache tile in shared memory (rounded to x's dtype, as
//     the reference widens it) and splits its contraction rows across the
//     8 warps (one reduction at the end). The blocks are small, so that
//     many stay resident per SM and keep loads in flight.
//
// Ragged edges in rows, m, n and r are masked in the kernels: the host
// pads nothing. Still CUDA-core fp32 FMAs: the tensor-core kernels are
// fused.cuh (K1-K3, K9/K10) and serve_matmul.cu's prefill K8. What is
// undone here: K4 and K5/K6 on the tensor cores (their compose is the
// one above), and K8 at decode width nearer its byte bound (12x, PERF.md
// section 6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr int NT = 256;                   // threads per block
constexpr int BN = 32;                    // output columns per block
constexpr int RC = 32;                    // rank columns per compose chunk

template <int MAXR_, int BK_>
struct Shape {
  static constexpr int MAXR = MAXR_;      // activation rows per block
  static constexpr int BK = BK_;          // rows of m per step
  static constexpr int TM = MAXR / 4;     // rows per thread in the matmul
  static constexpr int CJ = BK / (NT / BN);   // compose entries per thread
  static constexpr int AL = BK * RC / NT;     // X-chunk values per thread
  static constexpr int BL = BN * RC / NT;     // Y-chunk values per thread
};
using Wide = Shape<32, 32>;     // K4's compose tile
using Skinny = Shape<32, 128>;  // K5/K6's compose tile and K8's decode matmul

enum { X_F32 = 0, X_BF16 = 1 };           // activation dtype codes
enum { W_I8 = 0, W_F16 = 1 };             // cache dtype codes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The reference casts the composed tile to the activation dtype before
// the contraction (`w_tile.astype(x.dtype)`); so do we.
template <typename XT> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<XT>(v));
}

// ------------------------------------------------------- 16-byte vectors

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element i of a 16-byte vector of T, widened to fp32 (bit operations
// only, so the vector stays in registers).
template <typename T> __device__ __forceinline__ float elem(const uint4& v, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int i) {
  return __uint_as_float(word(v, i));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int i) {
  const uint32_t w = word(v, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& v, int i) {
  const uint32_t w = word(v, i >> 1);
  return __half2float(__ushort_as_half(static_cast<unsigned short>((i & 1) ? (w >> 16) : w)));
}
template <> __device__ __forceinline__ float elem<int8_t>(const uint4& v, int i) {
  const uint32_t w = word(v, i >> 2);
  return static_cast<float>(static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu));
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ------------------------------------------------------- rank-r compose

// Shared-memory slices of one rank chunk: a = X[k0:k0+BK, rc:rc+RC] and
// bt = Y[n0:n0+BN, rc:rc+RC]ᵀ, padded against bank conflicts.
template <class S>
struct FactorChunk {
  float a[S::BK][RC + 1];
  float bt[RC][BN + 1];
};

template <class S>
struct ChunkRegs {
  float a[S::AL];
  float b[S::BL];
};

template <class S>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ X,
                                            const float* __restrict__ Y, int m, int n,
                                            int r, int k0, int n0, int rc,
                                            ChunkRegs<S>& R) {
#pragma unroll
  for (int q = 0; q < S::AL; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int k = k0 + idx / RC, c = rc + idx % RC;
    R.a[q] = (k < m && c < r) ? __ldg(X + (size_t)k * r + c) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < S::BL; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int j = n0 + idx / RC, c = rc + idx % RC;
    R.b[q] = (j < n && c < r) ? __ldg(Y + (size_t)j * r + c) : 0.f;
  }
}

template <class S>
__device__ __forceinline__ void put_chunk(const ChunkRegs<S>& R, FactorChunk<S>& ch) {
#pragma unroll
  for (int q = 0; q < S::AL; ++q) {
    const int idx = threadIdx.x + q * NT;
    ch.a[idx / RC][idx % RC] = R.a[q];
  }
#pragma unroll
  for (int q = 0; q < S::BL; ++q) {
    const int idx = threadIdx.x + q * NT;
    ch.bt[idx % RC][idx / RC] = R.b[q];
  }
}

// acc[j] += Σ_rr a[kr + 8j][rr] · bt[rr][c] for this thread's tile
// entries (column c = tid % 32, rows kr + 8j with kr = tid / 32).
template <class S>
__device__ __forceinline__ void rank_accumulate(const FactorChunk<S>& ch,
                                                float (&acc)[S::CJ]) {
  const int c = threadIdx.x % BN, kr = threadIdx.x / BN;
#pragma unroll 4
  for (int rr = 0; rr < RC; ++rr) {
    const float b = ch.bt[rr][c];
#pragma unroll
    for (int j = 0; j < S::CJ; ++j) acc[j] += ch.a[kr + j * (NT / BN)][rr] * b;
  }
}

// acc[f] = (X[f] Y[f]ᵀ) on this thread's tile entries, for NF factor
// pairs at once; chunk rc+1 is fetched into registers while chunk rc is
// being accumulated. `ch` holds NF chunk buffers.
template <class S, int NF>
__device__ __forceinline__ void compose(const float* const (&X)[NF],
                                        const float* const (&Y)[NF], int m, int n,
                                        int r, int k0, int n0, FactorChunk<S>* ch,
                                        float (&acc)[NF][S::CJ]) {
  ChunkRegs<S> R[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int j = 0; j < S::CJ; ++j) acc[f][j] = 0.f;
    fetch_chunk<S>(X[f], Y[f], m, n, r, k0, n0, 0, R[f]);
  }
  for (int rc = 0; rc < r; rc += RC) {
#pragma unroll
    for (int f = 0; f < NF; ++f) put_chunk<S>(R[f], ch[f]);
    __syncthreads();
    if (rc + RC < r) {
#pragma unroll
      for (int f = 0; f < NF; ++f) fetch_chunk<S>(X[f], Y[f], m, n, r, k0, n0, rc + RC, R[f]);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) rank_accumulate<S>(ch[f], acc[f]);
    __syncthreads();
  }
}

// ------------------------------------------------------- K8 at decode

// Shared memory of one block: the widened cache tile ws[BK][BN], then
// the x tile (rows x BK, padded against bank conflicts).
constexpr int XS = Skinny::BK + 1;        // padded x-tile row stride
inline size_t smem_bytes(int rows) {
  const int nr = rows < Skinny::MAXR ? rows : Skinny::MAXR;
  return sizeof(float) * (size_t)(Skinny::BK * BN + nr * XS);
}

inline dim3 grid_for(int rows, int n) {
  return dim3((n + BN - 1) / BN, (rows + Skinny::MAXR - 1) / Skinny::MAXR);
}

// Counts of 16-byte vectors one thread moves per step.
template <typename XT, typename WT>
struct VecCounts {
  static constexpr int VX = 16 / sizeof(XT);             // x values per vector
  static constexpr int XSPR = Skinny::BK / VX;           // x vectors per tile row
  static constexpr int XSL = Skinny::MAXR * XSPR / NT;   // x vectors per thread
  static constexpr int VW = 16 / sizeof(WT);             // cache values per vector
  static constexpr int WSPR = BN / VW;                   // cache vectors per tile row
  static constexpr int WSL = (Skinny::BK * WSPR + NT - 1) / NT;
};

// Issue every global read of the step at k0 (x rows and cache tile)
// into registers; masked vectors load as zeros.
template <typename XT, typename WT>
__device__ __forceinline__ void fetch_tiles(const XT* __restrict__ xb,
                                            const WT* __restrict__ w, int nr, int m, int n,
                                            int n0, int k0,
                                            uint4 (&xr)[VecCounts<XT, WT>::XSL],
                                            uint4 (&wr)[VecCounts<XT, WT>::WSL]) {
  using C = VecCounts<XT, WT>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < C::XSL; ++q) {
    const int s = tid + q * NT;
    const int row = s / C::XSPR, k = k0 + (s % C::XSPR) * C::VX;
    xr[q] = (row < nr && k < m) ? load16(xb + (size_t)row * m + k) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int q = 0; q < C::WSL; ++q) {
    const int s = tid + q * NT;
    const int k = k0 + s / C::WSPR, j = n0 + (s % C::WSPR) * C::VW;
    wr[q] = (s < Skinny::BK * C::WSPR && k < m && j < n) ? load16(w + (size_t)k * n + j)
                                                         : make_uint4(0, 0, 0, 0);
  }
}

// y (rows, n) = (x (rows, m) · W (m, n)) · scale, W int8 or fp16 widened
// to x's dtype in shared memory; block (bx, by) owns columns 32 bx.. and
// rows 32 by.. (grid_for).
template <typename XT, typename WT>
__device__ __forceinline__ void tiled_matmul(const XT* __restrict__ x,
                                             const WT* __restrict__ w, XT* __restrict__ y,
                                             const float* __restrict__ scale, int rows, int m,
                                             int n, float* smem) {
  using S = Skinny;
  using C = VecCounts<XT, WT>;
  constexpr int VX = C::VX, XSPR = C::XSPR, XSL = C::XSL;
  constexpr int VW = C::VW, WSPR = C::WSPR, WSL = C::WSL;

  float (*ws)[BN] = reinterpret_cast<float (*)[BN]>(smem);
  float* xs = smem + S::BK * BN;

  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * S::MAXR;
  const int nr = min(S::MAXR, rows - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // matmul mapping: column quad cq, rows rg + 4i; warp w sums its own
  // KW rows of each step
  const int cq = lane % (BN / 4), rg = lane / (BN / 4);
  constexpr int KW = S::BK / (NT / 32);
  const int kw0 = warp * KW;
  const XT* xb = x + (size_t)row0 * m;
  const bool vec = aligned16(x) && m % VX == 0 && aligned16(w) && n % VW == 0;

  float acc[S::TM][4];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  uint4 xr[XSL];
  uint4 wr[WSL];
  if (vec) fetch_tiles<XT, WT>(xb, w, nr, m, n, n0, 0, xr, wr);

  for (int k0 = 0; k0 < m; k0 += S::BK) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < XSL; ++q) {
        const int s = tid + q * NT;
        const int row = s / XSPR, kk = (s % XSPR) * VX;
        if (row < nr) {
#pragma unroll
          for (int e = 0; e < VX; ++e) xs[row * XS + kk + e] = elem<XT>(xr[q], e);
        }
      }
#pragma unroll
      for (int q = 0; q < WSL; ++q) {
        const int s = tid + q * NT;
        if (s < S::BK * WSPR) {
          const int kk = s / WSPR, c = (s % WSPR) * VW;
#pragma unroll
          for (int e = 0; e < VW; ++e) ws[kk][c + e] = round_to<XT>(elem<WT>(wr[q], e));
        }
      }
    } else {  // unaligned shapes: masked scalar loads
      for (int idx = tid; idx < nr * S::BK; idx += NT) {
        const int row = idx / S::BK, kk = idx % S::BK;
        const int k = k0 + kk;
        xs[row * XS + kk] = k < m ? to_f(xb[(size_t)row * m + k]) : 0.f;
      }
      for (int idx = tid; idx < S::BK * BN; idx += NT) {
        const int kk = idx / BN, c = idx % BN;
        const int k = k0 + kk, j = n0 + c;
        ws[kk][c] = (k < m && j < n) ? round_to<XT>(to_f(w[(size_t)k * n + j])) : 0.f;
      }
    }
    __syncthreads();
    if (vec && k0 + S::BK < m)  // in flight during this step's work
      fetch_tiles<XT, WT>(xb, w, nr, m, n, n0, k0 + S::BK, xr, wr);

    // ---- contract the x tile with the weight tile
#pragma unroll 4
    for (int kk = kw0; kk < kw0 + KW; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][cq * 4]);
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        const int row = rg + i * 4;
        if (row < nr) {
          const float xv = xs[row * XS + kk];
          acc[i][0] += xv * wv.x;
          acc[i][1] += xv * wv.y;
          acc[i][2] += xv * wv.z;
          acc[i][3] += xv * wv.w;
        }
      }
    }
    __syncthreads();
  }

  // sum the 8 warps' partial products through shared memory (the tiles
  // are dead by now: the loop ended on a barrier). The per-output-channel
  // scale commutes with the row sum: applied once, to the fp32 sum.
  float* red = smem;
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = rg + i * 4;
    if (row < nr) {
#pragma unroll
      for (int q = 0; q < 4; ++q) red[(warp * nr + row) * BN + cq * 4 + q] = acc[i][q];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * BN; idx += NT) {
    const int row = idx / BN, col = n0 + idx % BN;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) v += red[(wi * nr + row) * BN + idx % BN];
    if (col < n) {
      if (scale != nullptr) v *= scale[col];
      y[(size_t)(row0 + row) * n + col] = from_f<XT>(v);
    }
  }
}

// Allow the block's dynamic shared memory above the 48 KB default (a
// host-side attribute call, set before every launch).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tiles
