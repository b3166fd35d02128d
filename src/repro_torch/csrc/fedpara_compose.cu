// FedPara compose for sm_90a on the tensor cores: the dense weight
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
// What bounds it on an H100: operations. The two rank-r products cost
// 4·m·n·r fp32 FLOPs. At fp32 accuracy on the tensor cores (3xTF32:
// three TF32 products per fp32 product, 495/3 TFLOP/s) one qwen3-8b
// layer at gamma 0.1 (ranks 160 / 70 / 211 for wq,wo / wk,wv /
// gate,up,down; 1.51e11 FLOPs) takes at least 0.92 ms; on the CUDA
// cores (67 TFLOP/s) it would take 2.26 ms. Its 193M output elements
// take 0.23 ms to write in fp32 and 0.12 ms in fp16.
//
// The design:
//   * one persistent block per SM walks the (layer, tile) pairs of the
//     whole launch, so K5 is K6's lead = 1 case and a 36-layer stack is
//     one launch; slab offsets are size_t;
//   * a tile is 128 rows (m: X's rows) x 128 columns (n: Y's rows) of W,
//     composed in units: one factor pair's chunk of 32 ranks. Two
//     consumer warpgroups own 64 rows each and compose with wgmma
//     m64n128k8 in TF32: A (X) in registers, B (Y) from shared memory,
//     both K-major as the factors lie (the rank axis contiguous). Every
//     fp32 operand is split into TF32 hi and lo and hi·hi + hi·lo +
//     lo·hi are summed (3xTF32, mma.cuh): fp32 accuracy. Every consumer
//     warp composes; none holds a contraction role;
//   * the copies: a TMA tensor map needs 16-byte row strides, which r =
//     70 and 211 do not give; 4-byte cp.async copies ran slower than
//     16-byte ones on this card, and bulk copies of single rows slower
//     still. So each row's 32 ranks come as the 16-byte aligned
//     run around them, the segment 0-3 floats in: nine 16-byte cp.async
//     copies (eight when aligned), into a ring of four stages, three
//     units ahead. Each consumer warp copies the 16 rows of X it reads
//     and 16 of Y's 128, between its units. What lies past the rank is
//     masked where it is read; copies past m, n and r read nothing and
//     write zeros, and no copy reads outside its factor (a second
//     instance of the kernel bounds each copy where a factor's ends lie
//     off 16-byte boundaries): the host pads nothing;
//   * a third warpgroup splits Y's chunk into TF32 halves once per unit
//     (not per fragment), realigned and in the 128-byte swizzle wgmma
//     reads, into one of two buffers; the consumers split X's values in
//     registers as they read them;
//   * the tensor core's fp32 accumulation truncates, so each unit (at
//     most 32 ranks) is summed in fresh registers (its first wgmma does
//     not accumulate) and added to the running sum on the CUDA cores;
//   * a tile composes X1 Y1ᵀ, keeps f1 of it in registers, then composes
//     X2 Y2ᵀ. f2 and the product are applied to the fp32 sums, each
//     element is rounded once to W's type, staged per warp through
//     shared memory and stored in 16-byte vectors. The stores are not
//     waited for, and the next tile's copies are already in flight;
//   * the split warpgroup runs on 40 registers and the consumers on 232
//     (setmaxnreg); every element of W is written by one block with a
//     fixed order of sums: the same inputs give the same bits.
//
// What holds it back (PERF.md section 6): the copies, the split and the
// products each take a large share of the kernel's time on their own,
// and they share the SM's issue slots and shared memory.
#include <algorithm>
#include <atomic>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };
enum { O_F32 = 0, O_F16 = 1, O_BF16 = 2 };   // output dtype codes

constexpr int BM = 128;                 // rows of W per tile (m)
constexpr int BN = 128;                 // columns of W per tile (n)
constexpr int RC = 32;                  // ranks per unit: 4 k-steps of 8
constexpr int RAW = 4;                  // stages of the copy ring
constexpr int SPL = 2;                  // buffers of Y's TF32 halves
constexpr int NC = 256;                 // consumer threads: warpgroups 0 and 1
constexpr int NP = 128;                 // split threads: warpgroup 2
constexpr int AHEAD = RAW - 1;          // units whose copies are in flight
constexpr int NT = NC + NP;
// a raw row: the 16-byte aligned run around a row's 32 ranks (nine
// 16-byte vectors; the rank segment starts 0-3 floats in)
constexpr int AST = RC + 4;
constexpr int B_BYTES = BN * RC * 4;    // one swizzled Y buffer (16 KB)
constexpr int SPLIT_BYTES = 2 * B_BYTES;              // Y hi, Y lo
constexpr int RAW_BYTES = (BM + BN) * AST * 4;        // X's rows, then Y's
constexpr int PIECE = 16;               // columns per epilogue staging round
constexpr int PST = PIECE + 8;          // staging row stride (elements)
constexpr int STG_WARP = 16 * PST * 4;  // staging bytes per consumer warp (fp32)
constexpr size_t SMEM = 1024 + (size_t)SPL * SPLIT_BYTES + (size_t)RAW * RAW_BYTES +
                        (NC / 32) * STG_WARP + (2 * RAW + SPL) * 8;
constexpr int P_REGS = 40, C_REGS = 232;   // setmaxnreg: split warps, consumers

struct Tile {
  size_t slab;   // index along the leading axis
  int m0, n0;    // first row and column of W
};
__device__ __forceinline__ Tile tile_at(long long t, long long per_slab, int tn) {
  const long long rem = t % per_slab;
  return {(size_t)(t / per_slab), (int)(rem / tn) * BM, (int)(rem % tn) * BN};
}

// A walk over a block's units in order (tile, factor pair, rank chunk),
// one step at a time: the divisions of tile_at once per tile, not per
// unit.
struct Units {
  long long t;    // the tile
  int u;          // the unit within it: u < nrc for X1·Y1ᵀ, then X2·Y2ᵀ
  Tile tl;
  __device__ __forceinline__ void start(long long per_slab, int tn) {
    t = blockIdx.x;
    u = 0;
    tl = tile_at(t, per_slab, tn);
  }
  __device__ __forceinline__ void next(int U, long long per_slab, int tn) {
    if (++u == U) {
      u = 0;
      t += gridDim.x;
      tl = tile_at(t, per_slab, tn);
    }
  }
};

// floats between p and the 16-byte boundary below it
__device__ __forceinline__ int shift_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ const float* align16(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) &
                                        ~static_cast<uintptr_t>(15));
}

// The 16-byte aligned vector at p into dst if ok, else zeros, reading
// only its floats in [lo, hi), the factor: the rest is zero-filled. A
// vector that runs past the factor's end reads its leading floats
// (cp.async's source size); one that starts before the factor (at its
// first row, when the factor does not start on a 16-byte boundary)
// copies float by float.
__device__ __forceinline__ void copy_vec(float* dst, const float* p, bool ok, const float* lo,
                                         const float* hi) {
  if (ok && p < lo) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = p + e >= lo && p + e < hi;
      mma::cp_async4(dst + e, in ? p + e : lo, in);
    }
    return;
  }
  const long long left = ok ? hi - p : 0;
  const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
  mma::cp_async16_n(dst, bytes ? p : lo, bytes);
}

// Sixteen factor rows [row0, row0 + 16) of a unit, ranks [k0, k0 + need),
// by one warp: raw row i gets the 16-byte aligned run around row
// row0 + i's ranks (rank k0 + kk at float shift_of(&F[row0 + i][k0]) +
// kk): eight 16-byte cp.async copies, and a ninth where the run starts
// off a 16-byte boundary. Lane l copies vector l % 8 of rows l / 8 + 4j
// (rows four apart share their shift) and the ninth of row l < 16.
// Copies past the factor's rows or past the rank read nothing and write
// zeros; what a copy brings past the rank is masked where it is read.
// Every vector copied holds a rank of the factor [lo, hi), so where lo
// and hi lie on 16-byte boundaries no vector crosses them; CLIP (either
// does not) bounds each copy by them. F: the slab.
template <bool CLIP>
__device__ __forceinline__ void copy16(float* raw, const float* F, const float* lo,
                                       const float* hi, int row0, int rows, int r, int k0,
                                       int need, int lane) {
  const int v = lane & 7, rg = lane >> 3;
  const float* a = F + (size_t)(row0 + rg) * r + k0;
  const int sh = shift_of(a);
#pragma unroll
  for (int j = 0; j < 4; ++j, a += 4 * (size_t)r) {
    const bool ok = row0 + rg + 4 * j < rows && 4 * v - sh < need;
    const float* p = align16(a) + 4 * v;
    float* dst = raw + (rg + 4 * j) * AST + 4 * v;
    if constexpr (CLIP) copy_vec(dst, p, ok, lo, hi);
    else mma::cp_async16(dst, ok ? p : lo, ok);
  }
  if (lane < 16) {
    const float* a9 = F + (size_t)(row0 + lane) * r + k0;
    const bool ok9 = row0 + lane < rows && 32 - shift_of(a9) < need;
    const float* p9 = align16(a9) + 32;
    if constexpr (CLIP) copy_vec(raw + lane * AST + 32, p9, ok9, lo, hi);
    else mma::cp_async16(raw + lane * AST + 32, ok9 ? p9 : lo, ok9);
  }
}

// Y's raw rows of a unit into its TF32 halves, in the 128-byte swizzle
// wgmma reads: hi = tf32(y) into spl, lo = y - hi beside it; ranks past
// the unit's `need` are zero. Split thread t owns 16-byte chunk c = t % 8
// (ranks 4c..4c+3) of rows t / 8 + 16i, which share their shift sh: it
// reads the two aligned vectors around the chunk and selects the four
// floats sh.. of them.
__device__ __forceinline__ void split_y(const float* raw, float* spl, int sh, int need,
                                        int t) {
  const int c = t & 7, rg = t >> 3;
  const bool s1 = sh & 1, s2 = sh & 2;
  const bool in0 = 4 * c < need, in1 = 4 * c + 1 < need, in2 = 4 * c + 2 < need,
             in3 = 4 * c + 3 < need;
#pragma unroll 4
  for (int i = 0; i < BN / 16; ++i) {
    const int row = rg + 16 * i;
    const float4 a = *reinterpret_cast<const float4*>(raw + row * AST + 4 * c);
    const float4 b = *reinterpret_cast<const float4*>(raw + row * AST + 4 * c + 4);
    // floats sh .. sh + 3 of (a, b): a shift by 2, then by 1
    const float t0 = s2 ? a.z : a.x, t1 = s2 ? a.w : a.y, t2 = s2 ? b.x : a.z,
                t3 = s2 ? b.y : a.w, t4 = s2 ? b.z : b.x;
    uint32_t h[4], l[4];
    mma::split(in0 ? (s1 ? t1 : t0) : 0.f, h[0], l[0]);
    mma::split(in1 ? (s1 ? t2 : t1) : 0.f, h[1], l[1]);
    mma::split(in2 ? (s1 ? t3 : t2) : 0.f, h[2], l[2]);
    mma::split(in3 ? (s1 ? t4 : t3) : 0.f, h[3], l[3]);
    const int at = mma::sw128(row, 4 * c);
    *reinterpret_cast<uint4*>(spl + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(spl + BN * RC + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One unit of this warpgroup's 64 rows: NK k-steps of the three TF32
// passes over all 128 columns into fresh registers (part: the tensor
// core's fp32 accumulation truncates, so each unit of at most 32 ranks
// is summed apart), then added to run on the CUDA cores. yb: the
// unit's Y hi buffer (lo follows it).
template <int NK>
__device__ __forceinline__ void unit_mma(float (&run)[64], float (&part)[64],
                                         const uint32_t (&ah)[4][4],
                                         const uint32_t (&al)[4][4], uint32_t yb) {
  const uint32_t hi = yb, lo = yb + B_BYTES;
  mma::own_regs(part);
  mma::wgmma_fence();
#pragma unroll
  for (int s = 0; s < NK; ++s) {
    mma::wgmma_tf32_n128(part, al[s], mma::sw128_desc(hi + 32 * s), s > 0);
    mma::wgmma_tf32_n128(part, ah[s], mma::sw128_desc(lo + 32 * s), 1);
    mma::wgmma_tf32_n128(part, ah[s], mma::sw128_desc(hi + 32 * s), 1);
  }
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::own_regs(part);
#pragma unroll
  for (int e = 0; e < 64; ++e) run[e] += part[e];
}

__device__ __forceinline__ float f2_of(float v, int kind) {
  return kind == K_TANH ? tanhf(v) : kind == K_PFEDPARA ? v + 1.f : v;
}

// two adjacent elements, each rounded once to the output type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Grid: min(tiles, SMs) persistent blocks of NT threads, SMEM bytes of
// dynamic shared memory. Block b takes tiles b, b + grid, ... of the
// lead x ⌈m/BM⌉ x ⌈n/BN⌉ tiles (layer-major, then rows, then columns);
// each tile is 2 x ⌈⌈r/8⌉/4⌉ units, X1·Y1ᵀ's first. Unit q's copies go
// to raw stage q % RAW and its Y halves to split buffer q % SPL.
template <typename OT, bool CLIP>
__global__ void __launch_bounds__(NT, 1)
compose_kernel(const float* __restrict__ x1, const float* __restrict__ y1,
               const float* __restrict__ x2, const float* __restrict__ y2,
               OT* __restrict__ w, int lead, int m, int n, int r, int kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tn = (n + BN - 1) / BN;
  const long long per_slab = (long long)((m + BM - 1) / BM) * tn;
  const long long tiles = per_slab * lead;
  const long long my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int nks = (r + 7) / 8;           // k-steps of 8 ranks
  const int nrc = (nks + 3) / 4;         // units per factor pair
  const int U = 2 * nrc;                 // units per tile
  const size_t xs = (size_t)m * r, ys = (size_t)n * r;   // slab sizes
  const long long units = my_tiles * U;
  // shared memory: the split buffers, the copy ring, the epilogue's
  // staging, then the barriers: ready[RAW] (unit split: the split
  // warps' 128 threads arrive), landed[RAW] (its copies in) and
  // sfree[SPL] (its Y halves read; the consumers' 256 arrive)
  auto split_buf = [&](int b) { return reinterpret_cast<float*>(smem + b * SPLIT_BYTES); };
  auto raw_stage = [&](int st) {
    return reinterpret_cast<float*>(smem + SPL * SPLIT_BYTES + st * RAW_BYTES);
  };
  unsigned char* const stg_base = smem + SPL * SPLIT_BYTES + RAW * RAW_BYTES;
  const uint32_t bars = mma::smem_u32(stg_base + (NC / 32) * STG_WARP);
  auto ready = [&](int st) { return bars + 8u * st; };
  auto landed = [&](int st) { return bars + 8u * (RAW + st); };
  auto sfree = [&](int b) { return bars + 8u * (2 * RAW + b); };
  if (tid == 0) {
    for (int st = 0; st < RAW; ++st) {
      mma::mbar_init(ready(st), NP);
      mma::mbar_init(landed(st), NC);
    }
    for (int b = 0; b < SPL; ++b) mma::mbar_init(sfree(b), NC);
    mma::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NC / 32) {
    // ---- split warps: unit q's Y into split buffer q % SPL once its
    // copies have landed and the buffer's last products are done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P_REGS));
    const int t = tid - NC;
    Units it;
    it.start(per_slab, tn);
    for (long long q = 0; q < units; ++q, it.next(U, per_slab, tn)) {
      const int sp = (int)(q % RAW), b = (int)(q % SPL);
      mma::mbar_wait(landed(sp), (uint32_t)((q / RAW) & 1));
      mma::mbar_wait(sfree(b), (uint32_t)((q / SPL) & 1) ^ 1u);
      const Tile tl = it.tl;
      const int u = it.u, k0 = (u < nrc ? u : u - nrc) * RC;
      const float* Y = (u < nrc ? y1 : y2) + tl.slab * ys;
      split_y(raw_stage(sp) + BM * AST, split_buf(b),
              shift_of(Y + (size_t)(tl.n0 + (t >> 3)) * r + k0), min(RC, r - k0), t);
      mma::fence_async_smem();
      mma::mbar_arrive(ready(sp));
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64wg.. of each tile, warp
  // `warp` rows 16·warp..: it copies those rows of X (the only ones it
  // reads) and the same rows of Y, AHEAD units ahead; each thread's
  // landed arrival fires when its copies are in
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C_REGS));
  Units it;   // the next unit to copy
  it.start(per_slab, tn);
  auto issue = [&](long long q) {
    if (q >= units) return;
    const Tile tl = it.tl;
    const int u = it.u, k0 = (u < nrc ? u : u - nrc) * RC, need = min(RC, r - k0);
    it.next(U, per_slab, tn);
    const float* X = u < nrc ? x1 : x2;
    const float* Y = u < nrc ? y1 : y2;
    float* raw = raw_stage((int)(q % RAW));
    copy16<CLIP>(raw + 16 * warp * AST, X + tl.slab * xs, X, X + lead * xs, tl.m0 + 16 * warp,
                 m, r, k0, need, lane);
    copy16<CLIP>(raw + (BM + 16 * warp) * AST, Y + tl.slab * ys, Y, Y + lead * ys,
                 tl.n0 + 16 * warp, n, r, k0, need, lane);
    mma::cp_async_arrive(landed((int)(q % RAW)));
  };
  for (int d = 0; d < AHEAD; ++d) issue(d);
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c4 = lane & 3;
  const int arow = 64 * wg + 16 * wl + g;   // this thread's first row of A
  OT* stg = reinterpret_cast<OT*>(stg_base + warp * STG_WARP);
  const bool vec = n % (16 / (int)sizeof(OT)) == 0 && tiles::aligned16(w);
  float f1v[64], run[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) part[e] = 0.f;
  long long q = 0;
  for (long long ti = 0; ti < my_tiles; ++ti) {
    const Tile tl = tile_at(blockIdx.x + ti * gridDim.x, per_slab, tn);
#pragma unroll 1
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int e = 0; e < 64; ++e) run[e] = 0.f;
      const float* X = (f ? x2 : x1) + tl.slab * xs + (size_t)(tl.m0 + arow) * r;
#pragma unroll 1
      for (int cu = 0; cu < nrc; ++cu, ++q) {
        const int st = (int)(q % RAW), k0 = cu * RC, need = min(RC, r - k0);
        mma::mbar_wait(ready(st), (uint32_t)((q / RAW) & 1));
        // A fragments of k-steps s < nk (rows arow, arow + 8), split into
        // TF32 halves; ranks past r are zero
        const int nk = min(4, nks - 4 * cu);
        const float* raw = raw_stage(st) + arow * AST + c4;
        const float* xa = raw + shift_of(X + k0);   // rows arow and arow + 8 share it
        const float* xb = xa + 8 * AST;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < nk) {
            const int k = 8 * s + c4;
            mma::split(k < need ? xa[8 * s] : 0.f, ah[s][0], al[s][0]);
            mma::split(k < need ? xb[8 * s] : 0.f, ah[s][1], al[s][1]);
            mma::split(k + 4 < need ? xa[8 * s + 4] : 0.f, ah[s][2], al[s][2]);
            mma::split(k + 4 < need ? xb[8 * s + 4] : 0.f, ah[s][3], al[s][3]);
          }
        }
        const int b = (int)(q % SPL);
        const uint32_t yb = mma::smem_u32(split_buf(b));
        if (nk == 4) unit_mma<4>(run, part, ah, al, yb);
        else if (nk == 3) unit_mma<3>(run, part, ah, al, yb);
        else if (nk == 2) unit_mma<2>(run, part, ah, al, yb);
        else unit_mma<1>(run, part, ah, al, yb);
        mma::mbar_arrive(sfree(b));
        // into the stage unit q - 1 left: its X rows were this warp's,
        // its Y split before it was ready
        issue(q + AHEAD);
      }
      if (f == 0) {
#pragma unroll
        for (int e = 0; e < 64; ++e) f1v[e] = kind == K_TANH ? tanhf(run[e]) : run[e];
      }
    }

    // ---- epilogue: run[4j + e] is W[row g + 8(e/2)][column 8j + 2c4 + e%2]
    // of this warp's 16 rows; PIECE columns at a time through the staging
    OT* out = w + tl.slab * (size_t)m * n;
    const int row0 = tl.m0 + 64 * wg + 16 * wl;
    constexpr int V = 16 / sizeof(OT), CPR = PIECE / V;
#pragma unroll
    for (int p = 0; p < BN / PIECE; ++p) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < PIECE / 8; ++jj) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * (p * (PIECE / 8) + jj) + 2 * hh;
          store2(stg + (g + 8 * hh) * PST + 8 * jj + 2 * c4, f1v[e] * f2_of(run[e], kind),
                 f1v[e + 1] * f2_of(run[e + 1], kind));
        }
      }
      __syncwarp();
      const int col0 = tl.n0 + p * PIECE;
#pragma unroll
      for (int i = 0; i < 16 * CPR / 32; ++i) {
        const int idx = lane + 32 * i, rr = idx / CPR, cv = (idx % CPR) * V;
        const int row = row0 + rr, col = col0 + cv;
        if (row < m && col < n) {
          OT* dst = out + (size_t)row * n + col;
          const OT* src = stg + rr * PST + cv;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < V && col + e < n; ++e) dst[e] = src[e];
          }
        }
      }
    }
  }
}

// The shared-memory attribute, and a check of the build: the consumers'
// setmaxnreg.inc waits until the block's registers cover what both
// roles ask for, so a kernel built with fewer registers per thread than
// that is refused here rather than launched to wait forever.
template <typename OT, bool CLIP>
cudaError_t prepare() {
  static std::atomic<int> regs{-1};
  int nr = regs.load();
  if (nr < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, compose_kernel<OT, CLIP>);
    if (err != cudaSuccess) return err;
    nr = attr.numRegs;
    regs.store(nr);
  }
  if ((long long)nr * NT < (long long)NP * P_REGS + (long long)NC * C_REGS)
    return cudaErrorInvalidConfiguration;
  return tiles::allow_smem(compose_kernel<OT, CLIP>, SMEM);
}

template <typename OT, bool CLIP>
int launch_as(int lead, const void* x1, const void* y1, const void* x2, const void* y2,
              void* w, int m, int n, int r, int kind, int sms, cudaStream_t s) {
  cudaError_t err = prepare<OT, CLIP>();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)lead * ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  compose_kernel<OT, CLIP><<<(unsigned)std::min<long long>(tiles, sms), NT, SMEM, s>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1),
      static_cast<const float*>(x2), static_cast<const float*>(y2), static_cast<OT*>(w), lead,
      m, n, r, kind);
  return (int)cudaGetLastError();
}

// The copies bound each vector by its factor's ends only where an end
// lies off a 16-byte boundary (a factor that starts off one, or whose
// lead·rows·r is not a multiple of 4), as at some ragged shapes; the
// bounds cost the kernel registers it spills.
template <typename OT>
int launch(int lead, const void* x1, const void* y1, const void* x2, const void* y2, void* w,
           int m, int n, int r, int kind, int sms, cudaStream_t s) {
  const size_t xb = (size_t)lead * m * r * 4, yb = (size_t)lead * n * r * 4;
  const uintptr_t off = reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(y1) |
                        reinterpret_cast<uintptr_t>(x2) | reinterpret_cast<uintptr_t>(y2) |
                        xb | yb;
  return off % 16 ? launch_as<OT, true>(lead, x1, y1, x2, y2, w, m, n, r, kind, sms, s)
                  : launch_as<OT, false>(lead, x1, y1, x2, y2, w, m, n, r, kind, sms, s);
}

}  // namespace

extern "C" {

// K5 and K6: for each slab c < lead, W[c] (m, n) = f1(X1[c] Y1[c]ᵀ) ⊙
// f2(X2[c] Y2[c]ᵀ); X1, X2 (lead, m, r) and Y1, Y2 (lead, n, r) fp32,
// W (lead, m, n), all contiguous; lead = 1 is K5's 2-D call; any rank
// r >= 0. kind: 0 fedpara | 1 fedpara_tanh | 2 pfedpara. out_dtype:
// 0 fp32 | 1 fp16 | 2 bf16. sms: the card's multiprocessor count (one
// persistent block each). Returns the launch's cudaError_t (0 on
// success).
int repro_fedpara_compose(const void* x1, const void* y1, const void* x2, const void* y2,
                          void* w, int lead, int m, int n, int r, int kind, int out_dtype,
                          int sms, void* stream) {
  if (lead <= 0 || m <= 0 || n <= 0) return 0;
  if (r < 0 || kind < K_FEDPARA || kind > K_PFEDPARA || sms <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case O_F32: return launch<float>(lead, x1, y1, x2, y2, w, m, n, r, kind, sms, s);
    case O_F16: return launch<__half>(lead, x1, y1, x2, y2, w, m, n, r, kind, sms, s);
    case O_BF16: return launch<__nv_bfloat16>(lead, x1, y1, x2, y2, w, m, n, r, kind, sms,
                                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory per block of the compose kernel (bytes).
size_t repro_fedpara_compose_smem_bytes() { return SMEM; }

}  // extern "C"
