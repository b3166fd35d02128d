// Shared tile machinery for the port's serve-path kernels (sm_90a).
//
// Every kernel here computes y = x · W' (· s) where W' is a weight tile
// that never exists in device memory: it is built in shared memory from
// what does live there (an int8/fp16 cache, rank-r factors, or both),
// cast to the activation dtype, and contracted at once. The kernels
// differ only in how a (BK x BN) tile of W' is built, so one driver,
// `tiled_matmul`, takes a tile builder (see serve_matmul.cu):
//
//   * W8Tile      — widen an int8 or fp16 cache tile (K8);
//   * ResidTile   — cache tile ⊙ (X2ᵤY2ᵤᵀ + 1) for one user (K9/K10).
//
// The compose kernels K5/K6 (fedpara_compose.cu) and the factor
// gradients K4 (fedpara_grad.cu) use the rank-r `compose` below on its
// own. The fused FedPara matmul (K1-K3, fedpara_matmul.cu) has its own
// tensor-core kernel.
//
// A block (256 threads) owns BN = 32 output columns and a group of
// activation rows, and walks the contraction axis m in steps of BK
// inside the block (Hopper has no sequential grid axis). Two block
// shapes:
//
//   * Wide   (rows > 32, prefill): up to 512 rows, BK = 32. Every row
//     of the block reuses each tile it built, so a 512-row prefill
//     builds each W' tile once, not once per row block as the TPU grid
//     did. The fp32 accumulators (512 x 32) sit in registers, 16 rows x
//     4 columns per thread.
//   * Skinny (rows <= 32, decode): BK = 128, so each step moves 4x the
//     cache bytes; the blocks are small enough that many stay resident
//     per SM and keep loads in flight.
//
// Each step first issues all of its global loads (16-byte vectors where
// the shapes allow, else a masked scalar path), then stores them to
// shared memory; the rank-r factor chunks of the compose are prefetched
// into registers one chunk ahead. Skinny blocks also prefetch the next
// step's x and cache tiles during this step, and split each step's
// contraction rows across their 8 warps (one reduction at the end). Ragged edges in rows, m, n and r are
// masked in the kernel: the host pads nothing.
//
// Still a simple first version: CUDA-core fp32 FMAs. Tensor cores
// (mma/wgmma), TMA and deeper pipelines are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr int NT = 256;                   // threads per block
constexpr int BN = 32;                    // output columns per block
constexpr int RC = 32;                    // rank columns per compose chunk
constexpr int RG = NT / (BN / 4);         // 32 row groups in the matmul

template <int MAXR_, int BK_>
struct Shape {
  static constexpr int MAXR = MAXR_;      // activation rows per block
  static constexpr int BK = BK_;          // contraction rows per step
  // Skinny blocks split each step's contraction rows across the 8 warps
  // (each warp sums its own slice; one reduction at the end) and
  // prefetch the next step's tiles into registers during this one.
  static constexpr bool SPLITK = MAXR <= 32;
  static constexpr int TM = SPLITK ? MAXR / 4 : MAXR / RG;  // rows per thread
  static constexpr int XS = BK + 1;       // padded x-tile row stride
  static constexpr int CJ = BK / (NT / BN);   // compose entries per thread
  static constexpr int AL = BK * RC / NT;     // X-chunk values per thread
  static constexpr int BL = BN * RC / NT;     // Y-chunk values per thread
};
using Wide = Shape<512, 32>;
using Skinny = Shape<32, 128>;

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

// ------------------------------------------------------- the driver

// Shared memory of one block: ws[BK][BN] | NCH factor chunks | x tile.
template <class S>
inline size_t smem_bytes(int rows, int nch) {
  const int nr = rows < S::MAXR ? rows : S::MAXR;
  return sizeof(float) * (size_t)(S::BK * BN + nr * S::XS) + nch * sizeof(FactorChunk<S>);
}

// Counts of 16-byte vectors one thread moves per step.
template <class S, typename XT, typename WT>
struct VecCounts {
  static constexpr int VX = 16 / sizeof(XT);          // x values per vector
  static constexpr int XSPR = S::BK / VX;             // x vectors per tile row
  static constexpr int XSL = S::MAXR * XSPR / NT;     // x vectors per thread
  static constexpr int VW = 16 / sizeof(WT);          // cache values per vector
  static constexpr int WSPR = BN / VW;                // cache vectors per tile row
  static constexpr int WSL = (S::BK * WSPR + NT - 1) / NT;
};

// Issue every global read of the step at k0 (x rows and cache tile)
// into registers; masked vectors load as zeros.
template <class S, typename XT, typename Tile>
__device__ __forceinline__ void fetch_tiles(
    const XT* __restrict__ xb, const Tile& tile, int nr, int m, int n, int n0, int k0,
    uint4 (&xr)[VecCounts<S, XT, typename Tile::WT>::XSL],
    uint4 (&wr)[VecCounts<S, XT, typename Tile::WT>::WSL]) {
  using C = VecCounts<S, XT, typename Tile::WT>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < C::XSL; ++q) {
    const int s = tid + q * NT;
    const int row = s / C::XSPR, k = k0 + (s % C::XSPR) * C::VX;
    xr[q] = (row < nr && k < m) ? load16(xb + (size_t)row * m + k) : make_uint4(0, 0, 0, 0);
  }
  if constexpr (Tile::kHasW) {
#pragma unroll
    for (int q = 0; q < C::WSL; ++q) {
      const int s = tid + q * NT;
      const int k = k0 + s / C::WSPR, j = n0 + (s % C::WSPR) * C::VW;
      wr[q] = (s < S::BK * C::WSPR && k < m && j < n) ? load16(tile.w + (size_t)k * n + j)
                                                      : make_uint4(0, 0, 0, 0);
    }
  }
}

// Tile interface (see the .cu files):
//   static constexpr bool kHasW; using WT = ...; const WT* w;
//   float prep(float) const           — what a cache value becomes in ws
//   void finish(k0, n0, ws, ch) const — compose into ws (syncs inside)
template <class S, typename XT, typename Tile>
__device__ __forceinline__ void tiled_matmul(const XT* __restrict__ x, XT* __restrict__ y,
                                             const float* __restrict__ scale, int rows,
                                             int m, int n, const Tile& tile, float* smem) {
  using WT = typename Tile::WT;
  using C = VecCounts<S, XT, WT>;
  constexpr int VX = C::VX, XSPR = C::XSPR, XSL = C::XSL;
  constexpr int VW = C::VW, WSPR = C::WSPR, WSL = C::WSL;

  float (*ws)[BN] = reinterpret_cast<float (*)[BN]>(smem);
  FactorChunk<S>* ch = reinterpret_cast<FactorChunk<S>*>(smem + S::BK * BN);
  float* xs = smem + S::BK * BN + Tile::kChunks * (sizeof(FactorChunk<S>) / sizeof(float));

  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * S::MAXR;
  const int nr = min(S::MAXR, rows - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // matmul mapping: column quad cq; rows rg + i * rstride
  const int cq = (S::SPLITK ? lane : tid) % (BN / 4);
  const int rg = (S::SPLITK ? lane : tid) / (BN / 4);
  constexpr int rstride = S::SPLITK ? 4 : RG;
  constexpr int KW = S::SPLITK ? S::BK / (NT / 32) : S::BK;   // k rows per warp
  const int kw0 = S::SPLITK ? warp * KW : 0;
  const XT* xb = x + (size_t)row0 * m;
  const bool xvec = aligned16(x) && m % VX == 0;
  bool wvec = true;
  if constexpr (Tile::kHasW) wvec = aligned16(tile.w) && n % VW == 0;
  const bool vec = xvec && wvec;

  float acc[S::TM][4];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  uint4 xr[XSL];
  uint4 wr[WSL];
  if (vec && S::SPLITK) fetch_tiles<S>(xb, tile, nr, m, n, n0, 0, xr, wr);

  for (int k0 = 0; k0 < m; k0 += S::BK) {
    if (vec) {
      if (!S::SPLITK) fetch_tiles<S>(xb, tile, nr, m, n, n0, k0, xr, wr);
#pragma unroll
      for (int q = 0; q < XSL; ++q) {
        const int s = tid + q * NT;
        const int row = s / XSPR, kk = (s % XSPR) * VX;
        if (row < nr) {
#pragma unroll
          for (int e = 0; e < VX; ++e) xs[row * S::XS + kk + e] = elem<XT>(xr[q], e);
        }
      }
      if constexpr (Tile::kHasW) {
#pragma unroll
        for (int q = 0; q < WSL; ++q) {
          const int s = tid + q * NT;
          if (s < S::BK * WSPR) {
            const int kk = s / WSPR, c = (s % WSPR) * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) ws[kk][c + e] = tile.prep(elem<WT>(wr[q], e));
          }
        }
      }
    } else {  // unaligned shapes: masked scalar loads
      for (int idx = tid; idx < nr * S::BK; idx += NT) {
        const int row = idx / S::BK, kk = idx % S::BK;
        const int k = k0 + kk;
        xs[row * S::XS + kk] = k < m ? to_f(xb[(size_t)row * m + k]) : 0.f;
      }
      if constexpr (Tile::kHasW) {
        for (int idx = tid; idx < S::BK * BN; idx += NT) {
          const int kk = idx / BN, c = idx % BN;
          const int k = k0 + kk, j = n0 + c;
          ws[kk][c] = (k < m && j < n) ? tile.prep(to_f(tile.w[(size_t)k * n + j])) : 0.f;
        }
      }
    }
    __syncthreads();
    if (vec && S::SPLITK && k0 + S::BK < m)  // in flight during this step's work
      fetch_tiles<S>(xb, tile, nr, m, n, n0, k0 + S::BK, xr, wr);
    tile.finish(k0, n0, ws, ch);
    __syncthreads();

    // ---- contract the x tile with the weight tile
#pragma unroll 4
    for (int kk = kw0; kk < kw0 + KW; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][cq * 4]);
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        const int row = rg + i * rstride;
        if (row < nr) {
          const float xv = xs[row * S::XS + kk];
          acc[i][0] += xv * w.x;
          acc[i][1] += xv * w.y;
          acc[i][2] += xv * w.z;
          acc[i][3] += xv * w.w;
        }
      }
    }
    __syncthreads();
  }

  // The per-output-channel scale commutes with the row sum: applied
  // once, to the fp32 accumulator.
  if constexpr (S::SPLITK) {
    // sum the 8 warps' partial products through shared memory (the
    // tiles are dead by now: the loop ended on a barrier)
    float* red = smem;
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int row = rg + i * rstride;
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
      for (int w = 0; w < NT / 32; ++w) v += red[(w * nr + row) * BN + idx % BN];
      if (col < n) {
        if (scale != nullptr) v *= scale[col];
        y[(size_t)(row0 + row) * n + col] = from_f<XT>(v);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = rg + i * rstride;
    if (row >= nr) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + cq * 4 + q;
      if (col < n) {
        float v = acc[i][q];
        if (scale != nullptr) v *= scale[col];
        y[(size_t)(row0 + row) * n + col] = from_f<XT>(v);
      }
    }
  }
}

template <class S>
inline dim3 grid_for(int rows, int n, int users) {
  return dim3((n + BN - 1) / BN, (rows + S::MAXR - 1) / S::MAXR, users);
}

// Allow the block's dynamic shared memory above the 48 KB default (a
// host-side attribute call, set before every launch).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tiles
