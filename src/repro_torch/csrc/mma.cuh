// Warp-level tensor-core and async-copy helpers for sm_90a (inline PTX):
// cp.async with zero fill (completed through mbarriers or groups),
// mbarriers, ldmatrix (plain and transposed), mma.sync for TF32
// (m16n8k8) and bf16 (m16n8k16) with fp32 accumulators, the TF32
// split behind the "3xTF32" products that keep fp32 accuracy on the
// tensor cores, and the warpgroup MMA (wgmma) in its TF32 form with
// the shared-memory descriptor and fences it needs.
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
// The same 16-byte copy reading only the first `bytes` (0..16) bytes
// of src and zero-filling the rest (cp.async's source size): a vector
// that runs past the end of its tensor reads nothing past it.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// The same 16-byte copy asking L2 to fetch the 256-byte block around
// it from device memory (a prefetch-size hint for streams read along a
// row by neighbouring blocks).
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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

// ---------------------------------------------------- warpgroup MMA
// wgmma (sm_90a): a warpgroup of four warps issues one asynchronous
// product of a 64-row tile. The kernels here use the TF32 form with A
// in registers and B in shared memory, both K-major:
//   A (64 x 8), per warp w of the group the mma.sync m16n8k8 TF32 A
//     fragment of rows 16w..16w+15: a0 (g, c), a1 (g+8, c), a2 (g, c+4),
//     a3 (g+8, c+4);
//   B (N x 8), N rows of 8 fp32 values read through a descriptor;
//   D (64 x N, fp32), per warp rows 16w..: d[4j+e] at row g + 8(e/2),
//     column 8j + 2c + e%2.
// The tensor core reads the top 19 bits of each 32-bit operand (TF32,
// truncated), as mma.sync does, so the 3xTF32 split above carries over.

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 32 fp32 values (128 bytes), the 16-byte chunk c of row j
// stored at chunk c ^ (j % 8), groups of 8 rows 1024 bytes apart, the
// buffer 1024-byte aligned. addr is the shared address of the first row
// plus 32 bytes per k-step of 8 values.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)   // start address, 16-byte units
         | ((uint64_t)1 << 16)                // leading offset (unused when swizzled)
         | ((uint64_t)(1024 >> 4) << 32)      // stride between 8-row groups
         | ((uint64_t)1 << 62);               // 128-byte swizzle
}
// float index of element (j, k < 32) of a rows-of-32 buffer in that swizzle
__host__ __device__ __forceinline__ int sw128(int j, int k) {
  return j * 32 + ((((k >> 2) ^ j) & 7) << 2) + (k & 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of r across a wgmma
// fence, commit or wait: the asynchronous product owns r in between.
template <int N>
__device__ __forceinline__ void own_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128) = a·bᵀ + (scale_d ? d : 0), TF32, A in registers.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}

}  // namespace mma
