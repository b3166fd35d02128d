// Shared CUDA-core helpers for sm_90a: dtype codes and conversions,
// 16-byte vector access, the rank-r tile compose of K5/K6, and the
// shared-memory attribute every kernel with more than 48 KB of dynamic
// shared memory needs.
//
//   * `compose` builds (X Y^T) on a (BK x BN) tile for one or two factor
//     pairs in fp32 on the CUDA cores: rank chunks of RC = 32 staged in
//     shared memory, the next chunk prefetched into registers while this
//     one is accumulated. The compose kernels K5/K6 (fedpara_compose.cu,
//     Skinny: 128 x 32 tiles) use it; the other kernels compose on the
//     tensor cores (fused.cuh, fedpara_grad.cu).
//   * `allow_smem` raises a kernel's dynamic shared-memory limit once
//     per kernel and device, not at every launch: decode is bound by
//     host time.
//
// Ragged edges in m, n and r are masked in the kernels: the host pads
// nothing. What is undone here: K5/K6 on the tensor cores (PERF.md
// section 6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace tiles {

constexpr int NT = 256;                   // threads per block
constexpr int BN = 32;                    // output columns per block
constexpr int RC = 32;                    // rank columns per compose chunk

template <int BK_>
struct Shape {
  static constexpr int BK = BK_;          // rows of W per tile
  static constexpr int CJ = BK / (NT / BN);   // compose entries per thread
  static constexpr int AL = BK * RC / NT;     // X-chunk values per thread
  static constexpr int BL = BN * RC / NT;     // Y-chunk values per thread
};
using Skinny = Shape<128>;      // K5/K6's compose tile

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

// Allow `kernel` `bytes` of dynamic shared memory (above the 48 KB
// default). The attribute is a host-side call per kernel and device:
// it is made the first time a kernel asks for more than it was last
// allowed on the current device, and a launch that needs no more makes
// no call at all.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::vector<std::pair<std::pair<const void*, int>, size_t>> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (auto& e : allowed) {
    if (e.first.first == kernel && e.first.second == dev) {
      if (bytes <= e.second) return cudaSuccess;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err == cudaSuccess) e.second = bytes;
      return err;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed.push_back({{kernel, dev}, bytes});
  return err;
}
template <typename K>
inline cudaError_t allow_smem(K* kernel, size_t bytes) {
  return allow_smem(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace tiles
