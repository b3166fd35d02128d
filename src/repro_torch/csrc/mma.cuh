// Warp-level tensor-core and async-copy helpers for sm_90a (inline PTX):
// cp.async with zero fill (completed through mbarriers or groups),
// mbarriers, ldmatrix (plain and transposed), mma.sync for TF32
// (m16n8k8) and bf16 (m16n8k16) with fp32 accumulators, and the TF32
// split behind the "3xTF32" products that keep fp32 accuracy on the
// tensor cores.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16, .row.col), with
// g = lane / 4 and c = lane % 4:
//   TF32 A (16 x 8):  a0 (g, c)   a1 (g+8, c)   a2 (g, c+4)   a3 (g+8, c+4)
//   TF32 B (8 x 8):   b0 (k = c, n = g)         b1 (k = c+4, n = g)
//   C (16 x 8, fp32): c0 (g, 2c)  c1 (g, 2c+1)  c2 (g+8, 2c)  c3 (g+8, 2c+1)
// A product sums over k in any order, so a caller may map the MMA's k
// index to memory as it likes, provided A and B agree: the kernels here
// map k = c to the even and k = c+4 to the odd element of an adjacent
// pair, so each thread fetches its two values with one 8-byte load.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies of 4, 8 or 16 bytes. With
// `valid` false no byte is read from src and the destination is filled
// with zeros: ragged edges are masked this way.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
template <int V>   // V floats
__device__ __forceinline__ void cp_async_f(float* dst, const float* src, bool valid) {
  if constexpr (V == 4) cp_async16(dst, src, valid);
  if constexpr (V == 2) cp_async8(dst, src, valid);
  if constexpr (V == 1) cp_async4(dst, src, valid);
}
// mbarriers in shared memory (addresses from smem_u32). A stage of a
// ring has a "full" barrier, completed when its producers' copies have
// landed (cp_async_arrive: one arrival per producer thread, counted in
// the init), and an "empty" one that its consumers arrive on when done.
// The k-th use of a stage waits on full with parity k & 1 and refills
// after empty with parity (k & 1) ^ 1 (passes at once for k = 0).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n" : "=l"(state) : "r"(bar) : "memory");
}
// arrive on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// whether the phase of the given parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async groups: commit this thread's copies issued so far as one
// group; wait until at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: x4 loads a 16 x 16 bf16 A fragment (lane l gives the address
// of row l % 16, column 8 * (l / 16)); x2 loads a 16 (k) x 8 (n) B
// fragment from an [n][k] array (lane l < 16 gives row l % 8, column
// 8 * (l / 8)).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// x4.trans loads two 16 (k) x 8 (n) B fragments from a [k][n] array:
// lane l gives the address of row 8 * ((l / 8) % 2) + l % 8, column
// 8 * (l / 16); r[0], r[1] are the B fragment of columns 0-7, r[2],
// r[3] that of columns 8-15.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a · b on the tensor cores, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TF32 rounding of an fp32 value: to nearest, ties away from zero, 10
// mantissa bits kept (the low 13 cleared), by integer operations on the
// bit pattern. kernels/ref.py:tf32_round is the same operation on the
// host.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo with hi = tf32(v) and lo = v - hi, exact in fp32. lo goes
// to the MMA as it is: the tensor core reads the top 19 bits of a TF32
// operand, so lo enters truncated to TF32 (an error of at most 2^-11 of
// lo, 2^-22 of v; kernels/ref.py:split_3xtf32 does the same).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The three passes of a 3xTF32 product d += a·b at fp32 accuracy:
// a_lo·b_hi, a_hi·b_lo, then a_hi·b_hi (the a_lo·b_lo term, 2^-22 of the
// product, is dropped). Each pass depends on the previous one through d,
// so a caller issues pass p for all of its independent accumulators
// before pass p + 1 rather than the three back to back.
template <int P>
__device__ __forceinline__ void mma_pass(float (&d)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                         const uint32_t (&blo)[2]) {
  if constexpr (P == 0) mma_tf32(d, alo, bhi);
  if constexpr (P == 1) mma_tf32(d, ahi, blo);
  if constexpr (P == 2) mma_tf32(d, ahi, bhi);
}

// The tensor core's fp32 accumulation truncates, so an error grows with
// the number of MMAs summed into one accumulator. The kernels sum a
// bounded run (one rank chunk, one step of m) into fresh registers and
// add that to the running total on the CUDA cores, which round.
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N], float (&part)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    acc[e] += part[e];
    part[e] = 0.f;
  }
}

}  // namespace mma
