// Shared CUDA-core helpers for sm_90a: dtype codes and conversions,
// 16-byte vector access, and the shared-memory attribute every kernel
// with more than 48 KB of dynamic shared memory needs.
//
//   * `allow_smem` raises a kernel's dynamic shared-memory limit once
//     per kernel and device, not at every launch: decode is bound by
//     host time.
//
// Every rank-r compose of the port runs on the tensor cores (fused.cuh
// for K1-K3 and K9/K10, fedpara_grad.cu for K4, fedpara_compose.cu for
// K5/K6); what is left here serves all kernels alike.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace tiles {

constexpr int NT = 256;                   // threads per block (K7)

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
