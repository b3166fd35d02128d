// The fused low-rank matmul on the tensor cores (sm_90a), generic over
// what each weight tile is built from:
//   y[c] = x[c] · W[c],  W[c] = op.weight(rank-r products, cache)
// for every client (or serve user) c on grid z. Two operations use it:
//   * FedparaOp (fedpara_matmul.cu, K1-K3): two rank-r products,
//     W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ);
//   * ResidOp (serve_matmul.cu, K9/K10): one rank-r product against a
//     shared int8 / fp16 cache, W = cache ⊙ (X2ᵤ Y2ᵤᵀ + 1), scaled per
//     output column at the store.
// The operation is a template parameter: each instantiation compiles
// its own hot loop, with no run-time branch on the operation in it.
//
// The design (fedpara_matmul.cu's note gives the K1 numbers):
//   * the transposed product: a block owns BN = 32 output columns and
//     up to RMAX (128 or 512) activation rows of one client, and walks
//     the contraction axis m in steps of BK = 64. Per step it composes
//     the Wᵀ tile (32 x 64) once for all of its rows: each rank product
//     Y · Xᵀ with the columns n as the MMA's M, the step's rows of m as
//     its N and the rank as its k, mma.sync m16n8k8 TF32 in three passes
//     (3xTF32: every fp32 operand split into TF32 hi and lo halves,
//     hi·hi + hi·lo + lo·hi), each compose warp a 16 x 16 tile; r is
//     padded with zeros to a multiple of 8 in shared memory;
//   * two roles of 8 warps each. The compose warps hold no accumulator
//     of the output; they read Y[n-tile, :r] (loaded once per block)
//     and X's rank chunks (64 rows x 32 ranks per factor) from a ring of
//     three shared-memory stages, and write each step's tile to one of
//     two W buffers. The contraction warps hold the output's fp32
//     accumulators, fill the X ring with cp.async (16-, 8- or 4-byte
//     copies as r and the pointers allow; full and empty mbarriers per
//     stage, no block barrier per chunk), load each step's x tile and
//     contract the last step's W tile while the next one is composed:
//     yᵀ += Wᵀ · xᵀ, bf16 m16n8k16 (ldmatrix) or 3xTF32 m16n8k8. One
//     named barrier per step hands a W buffer over;
//   * a cache tile (ResidOp) does not go through the ring: each compose
//     thread loads the 8 cache entries it multiplies straight into
//     registers, one step ahead (2 KB per step and block at int8), so
//     ragged or unaligned n needs no other copy path;
//   * op.weight is applied to the compose's fp32 sums in registers and
//     the tile is rounded once, to bf16 for bf16 activations (as the
//     reference casts its tile), or split into TF32 halves for fp32;
//   * the tensor core's fp32 accumulation truncates, so each rank chunk
//     (32) and each step of the fp32 contraction is summed in fresh
//     registers and added to the running sum on the CUDA cores;
//   * launches that give fewer blocks than the card holds split m
//     across blocks (splits_for): the partial sums go to an fp32
//     workspace from the caller and reduce_splits adds them in a fixed
//     order (and applies the column scale). No float atomics: every run
//     gives the same bits;
//   * ragged rows, m, n and r are masked in the kernel (zero-filled
//     copies); the host pads nothing.
#pragma once

#include <algorithm>
#include <type_traits>

#include "mma.cuh"
#include "tiles.cuh"

namespace fused {

using tiles::from_f;

constexpr int NR = 256;          // threads per role: 8 warps
constexpr int NT = 2 * NR;       // threads per block: 8 compose warps, 8 contraction warps
constexpr int BN = 32;           // output columns per block (MMA M)
constexpr int BK = 64;           // rows of m per step
constexpr int RC = 32;           // rank columns per X chunk
constexpr int STAGES = 3;        // X chunks in flight
constexpr int XST = RC + 8;      // X chunk row stride (floats), 8 mod 16
constexpr int KST = BK + 8;      // x tile and W tile row stride (elements)
constexpr int MAX_SMEM = 232448; // per block on an H100

__host__ __device__ constexpr int pad_rank(int r) { return (r + 7) & ~7; }
// Y row stride: 8 mod 16 floats, so the eight-byte fragment loads of a
// half-warp (4 rows x 8 floats) hit 32 distinct banks.
__host__ __device__ constexpr int y_stride(int r) {
  return pad_rank(r) % 16 == 0 ? pad_rank(r) + 8 : pad_rank(r);
}

template <int NF, typename XT, int RMAX>
inline size_t smem_bytes(int r) {
  const size_t w = 2 * (sizeof(XT) == 2 ? 2 * BN * KST : 2 * 4 * BN * KST);  // W: 2 x (bf16 | hi, lo)
  return 4 * (size_t)(NF * BN * y_stride(r) + STAGES * NF * BK * XST) +
         sizeof(XT) * (size_t)RMAX * KST + w + 2 * STAGES * sizeof(uint64_t);
}

// bar.sync on named barrier ID for N threads (ID 0 is __syncthreads')
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}
enum { BAR_STEP = 1, BAR_COMPOSE = 2, BAR_CONTRACT = 3 };

using tiles::aligned16;

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ int8_t zero_of<int8_t>() { return 0; }
template <> __device__ __forceinline__ __half zero_of<__half>() { return __ushort_as_half(0); }

// An operation (Op) provides:
//   static constexpr int NF       rank-r factor pairs composed per tile
//   static constexpr bool kCache  whether a shared (m, n) cache enters
//   using CT                      the cache's element type
//   const CT* cache; const float* scale   (cache: kCache only; scale may be null)
//   void factors(c, m, n, r, X, Y) const  client c's NF factor pointers
//   float weight(p, w) const      W from the NF rank products p and the
//                                 cache value w (0 without a cache)
//
// Grid: (⌈n/BN⌉, row blocks x splits, clients). Block (bx, by, c)
// computes out[c][row0 : row0+RMAX, n0 : n0+BN] over its split's steps
// of m: into y (scaled) when splits == 1, else into ws[split][c] (fp32,
// unscaled). Warps 0-7 compose the W tiles, warps 8-15 hold the output
// accumulators and contract each tile while the next one is composed.
// Blocks per SM a configuration is compiled for: two at decode widths
// (RMAX = 64, one rank product per tile), so that 16 compose warps share
// an SM and hide each other's latency; else one.
template <int NF, int RMAX>
__host__ __device__ constexpr int min_blocks() { return NF == 1 && RMAX <= 64 ? 2 : 1; }

template <class Op, typename XT, int RMAX>
__global__ void __launch_bounds__(NT, min_blocks<Op::NF, RMAX>())
fused_kernel(const Op op, const XT* __restrict__ x, XT* __restrict__ y,
             float* __restrict__ ws, int rows, int m, int n, int r, int splits) {
  constexpr int NF = Op::NF;
  constexpr int RW = RMAX / 8;      // activation rows per contraction warp
  constexpr int NQ = RW / 8;        // their n8 tiles
  constexpr bool BF16 = sizeof(XT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = tid % NR, rw = warp % 8;   // thread and warp within the role
  const bool composer = warp < 8;
  const int g = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int row_blocks = (rows + RMAX - 1) / RMAX;
  const int rb = blockIdx.y % row_blocks, split = blockIdx.y / row_blocks;
  const int row0 = rb * RMAX, nr = min(RMAX, rows - row0), nr8 = (nr + 7) & ~7;
  const size_t cl = blockIdx.z;
  x += (cl * rows + row0) * (size_t)m;
  const float* Xf[NF];
  const float* Yf[NF];
  op.factors(cl, m, n, r, Xf, Yf);

  const int RP = pad_rank(r), ys = y_stride(r);
  const int nrc = max(1, (RP + RC - 1) / RC);        // rank chunks per step
  const int steps = (m + BK - 1) / BK;
  const int s0 = (int)((long long)steps * split / splits);
  const int s1 = (int)((long long)steps * (split + 1) / splits);
  const int total = (s1 - s0) * nrc;                 // X chunks of this block

  float* Ys = reinterpret_cast<float*>(smem);        // [NF][BN][ys]
  float* Xs = Ys + NF * BN * ys;                     // [STAGES][NF][BK][XST]
  XT* xs = reinterpret_cast<XT*>(Xs + STAGES * NF * BK * XST);   // [RMAX][KST]
  // W tile buffers [2]: bf16 [BN][KST] | fp32 hi [BN][KST], lo [BN][KST]
  void* wsm = xs + RMAX * KST;
  // the X ring's barriers: full[STAGES], then empty[STAGES]
  const uint32_t bars = mma::smem_u32(reinterpret_cast<unsigned char*>(wsm) +
                                      2 * (BF16 ? 2 * BN * KST : 2 * 4 * BN * KST));
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (STAGES + st); };

  // factor rows are copied in vectors of fv floats (16, 8 or 4 bytes)
  bool al16 = true;
  uintptr_t bits = 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    al16 = al16 && aligned16(Xf[f]) && aligned16(Yf[f]);
    bits |= (uintptr_t)Xf[f] | (uintptr_t)Yf[f];
  }
  const int fv = r % 4 == 0 && al16 ? 4 : r % 2 == 0 && bits % 8 == 0 ? 2 : 1;
  constexpr int VX = 16 / sizeof(XT);
  const bool xvec = m % VX == 0 && aligned16(x);

  // ---- loaders (every thread of the role issues its share; zero fill
  // outside). The composers load Y; the contraction warps X's chunks
  // and x's tiles.
  auto load_y = [&]() {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      for (int i = rt; i < BN * RP; i += NR) {
        const int nn = i / RP, j = i % RP;
        const bool ok = n0 + nn < n && j < r;
        mma::cp_async4(Ys + (f * BN + nn) * ys + j, Yf[f] + (size_t)(n0 + nn) * r + j, ok);
      }
    }
  };
  // chunk q: rows k0..k0+BK-1 and rank columns rc..rc+RC-1 of every X.
  // A thread owns one column vector and every (NR / (RC / V))-th row, so
  // its addresses advance by a constant stride.
  auto load_chunk_v = [&](auto vtag, int q) {
    constexpr int V = decltype(vtag)::value;
    constexpr int CPR = RC / V, RPP = NR / CPR;
    const int k0 = (s0 + q / nrc) * BK, rc = (q % nrc) * RC;
    const int jc = rt % CPR, rg = rt / CPR, j = rc + jc * V;
    float* dst = Xs + (q % STAGES) * NF * BK * XST + rg * XST + jc * V;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* src = Xf[f] + (size_t)(k0 + rg) * r + j;
#pragma unroll
      for (int i = 0; i < BK / RPP; ++i)
        mma::cp_async_f<V>(dst + (f * BK + i * RPP) * XST, src + (size_t)i * RPP * r,
                           j < r && k0 + rg + i * RPP < m);
    }
  };
  auto load_chunk = [&](int q) {
    if (fv == 4) load_chunk_v(std::integral_constant<int, 4>(), q);
    else if (fv == 2) load_chunk_v(std::integral_constant<int, 2>(), q);
    else load_chunk_v(std::integral_constant<int, 1>(), q);
  };
  auto load_x = [&](int s) {
    const int k0 = s * BK;
    if (xvec) {
      constexpr int CPR = BK / VX, RPP = NR / CPR;
      const int kk = (rt % CPR) * VX, rg = rt / CPR;
      const XT* src = x + (size_t)rg * m + k0 + kk;
      for (int row = rg; row < nr8; row += RPP, src += (size_t)RPP * m)
        mma::cp_async16(xs + row * KST + kk, src, row < nr && k0 + kk < m);
    } else if constexpr (!BF16) {
      for (int i = rt; i < nr8 * BK; i += NR) {
        const int row = i / BK, kk = i % BK;
        mma::cp_async4(xs + row * KST + kk, x + (size_t)row * m + k0 + kk,
                       row < nr && k0 + kk < m);
      }
    } else {  // bf16 rows not a multiple of 16 bytes: plain loads
      for (int i = rt; i < nr8 * BK; i += NR) {
        const int row = i / BK, kk = i % BK;
        xs[row * KST + kk] =
            (row < nr && k0 + kk < m) ? x[(size_t)row * m + k0 + kk] : zero_of<XT>();
      }
    }
  };

  // ---- compose: warp (wn, wk) owns Wᵀ rows nb..nb+15 (n) and columns
  // kb..kb+15 (m) of the step's 32 x 64 tile, every factor. A rank chunk
  // is summed into pc (pass by pass over the accumulators), then added
  // to the step's cw on the CUDA cores (mma::add_to).
  const int nb = (rw & 1) * 16, kb = (rw >> 1) * 16;
  float cw[NF][2][4];   // [factor][n8 tile][C fragment]
  float pc[NF][2][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int t = 0; t < 2; ++t) pc[f][t][0] = pc[f][t][1] = pc[f][t][2] = pc[f][t][3] = 0.f;
  auto compose_chunk = [&](const float* stage, int rc) {
#pragma unroll
    for (int j8 = 0; j8 < RC / 8; ++j8) {
      if (rc + j8 * 8 < RP) {
        const int jo = rc + j8 * 8 + 2 * c4;
        uint32_t ah[NF][4], al[NF][4], bh[NF][2][2], bl[NF][2][2];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float* Yt = Ys + f * BN * ys;
          const float2 ya = *reinterpret_cast<const float2*>(Yt + (nb + g) * ys + jo);
          const float2 yb = *reinterpret_cast<const float2*>(Yt + (nb + g + 8) * ys + jo);
          mma::split(ya.x, ah[f][0], al[f][0]);
          mma::split(yb.x, ah[f][1], al[f][1]);
          mma::split(ya.y, ah[f][2], al[f][2]);
          mma::split(yb.y, ah[f][3], al[f][3]);
          const float* Xt = stage + f * BK * XST;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float2 xv = *reinterpret_cast<const float2*>(
                Xt + (kb + 8 * t + g) * XST + jo - rc);
            mma::split(xv.x, bh[f][t][0], bl[f][t][0]);
            mma::split(xv.y, bh[f][t][1], bl[f][t][1]);
          }
        }
        // pass by pass over the independent accumulators
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int t = 0; t < 2; ++t) mma::mma_pass<0>(pc[f][t], ah[f], al[f], bh[f][t], bl[f][t]);
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int t = 0; t < 2; ++t) mma::mma_pass<1>(pc[f][t], ah[f], al[f], bh[f][t], bl[f][t]);
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int t = 0; t < 2; ++t) mma::mma_pass<2>(pc[f][t], ah[f], al[f], bh[f][t], bl[f][t]);
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int t = 0; t < 2; ++t) mma::add_to(cw[f][t], pc[f][t]);
  };
  // This thread's cache entries of step s: [t][h][e] is Wᵀ row
  // nb+g+8h, column kb+8t+2c4+e, i.e. cache[k0+kb+8t+2c4+e][n0+nb+g+8h]
  // (zero outside). Loaded a step ahead, widened at use.
  using CT = typename Op::CT;
  CT wc[2][2][2];
  auto load_cache = [&](int s) {
    if constexpr (Op::kCache) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = s * BK + kb + 8 * t + 2 * c4 + e, j = n0 + nb + g + 8 * h;
            wc[t][h][e] = (s < s1 && k < m && j < n) ? __ldg(op.cache + (size_t)k * n + j)
                                                     : zero_of<CT>();
          }
    }
  };
  auto cache_at = [&](int t, int h, int e) -> float {
    if constexpr (Op::kCache) return tiles::to_f(wc[t][h][e]);
    return 0.f;
  };
  // op.weight of this warp's entries into W tile buffer b
  auto store_w = [&](int b) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0[NF], p1[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          p0[f] = cw[f][t][2 * h];
          p1[f] = cw[f][t][2 * h + 1];
        }
        const float w0 = op.weight(p0, cache_at(t, h, 0));
        const float w1 = op.weight(p1, cache_at(t, h, 1));
        const int at = (nb + g + 8 * h) * KST + kb + 8 * t + 2 * c4;
        if constexpr (BF16) {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(wsm) +
                                             b * BN * KST + at) = __floats2bfloat162_rn(w0, w1);
        } else {
          uint32_t h0, l0, h1, l1;
          mma::split(w0, h0, l0);
          mma::split(w1, h1, l1);
          uint32_t* wh = reinterpret_cast<uint32_t*>(wsm) + b * 2 * BN * KST;
          *reinterpret_cast<uint2*>(wh + at) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(wh + BN * KST + at) = make_uint2(l0, l1);
        }
      }
    }
  };

  // ---- contraction: contraction warp rw owns activation rows
  // r0..r0+RW-1, all BN columns: acc[i][q] is the C fragment of columns
  // 16i.. x rows r0+8q... A step's contraction runs in NSL slices of 16
  // rows of m.
  constexpr int NSL = BK / 16;
  const int r0 = rw * RW;
  float acc[2][NQ][4];
  float pt[BF16 ? 1 : 2][NQ][4];   // fp32: one step's partial sums
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      acc[i][q][0] = acc[i][q][1] = acc[i][q][2] = acc[i][q][3] = 0.f;
      if constexpr (!BF16) pt[i][q][0] = pt[i][q][1] = pt[i][q][2] = pt[i][q][3] = 0.f;
    }

  auto contract_slice = [&](int b, int sl) {
    if (r0 >= nr) return;   // warp-uniform: this warp's rows are all past the edge
    if constexpr (BF16) {
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(wsm) + b * BN * KST;
      const int kk = sl * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma::ldsm_x4(a[i], wb + (16 * i + (lane & 15)) * KST + kk + 8 * (lane >> 4));
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (r0 + 8 * q < nr) {
          uint32_t bb[2];
          mma::ldsm_x2(bb, xs + (r0 + 8 * q + (lane & 7)) * KST + kk + 8 * ((lane >> 3) & 1));
          mma::mma_bf16(acc[0][q], a[0], bb);
          mma::mma_bf16(acc[1][q], a[1], bb);
        }
      }
    } else {
      // 3xTF32 into pt, added to acc on the CUDA cores after the last slice
      const uint32_t* wh = reinterpret_cast<const uint32_t*>(wsm) + b * 2 * BN * KST;
      const uint32_t* wl = wh + BN * KST;
      const float* xf = reinterpret_cast<const float*>(xs);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = (2 * sl + u) * 8 + 2 * c4;
        uint32_t ah[2][4], al[2][4], bh[NQ][2], bl[NQ][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint2 h0 = *reinterpret_cast<const uint2*>(wh + (16 * i + g) * KST + kk);
          const uint2 h1 = *reinterpret_cast<const uint2*>(wh + (16 * i + g + 8) * KST + kk);
          const uint2 l0 = *reinterpret_cast<const uint2*>(wl + (16 * i + g) * KST + kk);
          const uint2 l1 = *reinterpret_cast<const uint2*>(wl + (16 * i + g + 8) * KST + kk);
          ah[i][0] = h0.x; ah[i][1] = h1.x; ah[i][2] = h0.y; ah[i][3] = h1.y;
          al[i][0] = l0.x; al[i][1] = l1.x; al[i][2] = l0.y; al[i][3] = l1.y;
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (r0 + 8 * q < nr) {
            const float2 xv = *reinterpret_cast<const float2*>(xf + (r0 + 8 * q + g) * KST + kk);
            mma::split(xv.x, bh[q][0], bl[q][0]);
            mma::split(xv.y, bh[q][1], bl[q][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (r0 + 8 * q < nr) {
#pragma unroll
            for (int i = 0; i < 2; ++i) mma::mma_pass<0>(pt[i][q], ah[i], al[i], bh[q], bl[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (r0 + 8 * q < nr) {
#pragma unroll
            for (int i = 0; i < 2; ++i) mma::mma_pass<1>(pt[i][q], ah[i], al[i], bh[q], bl[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (r0 + 8 * q < nr) {
#pragma unroll
            for (int i = 0; i < 2; ++i) mma::mma_pass<2>(pt[i][q], ah[i], al[i], bh[q], bl[q]);
          }
        }
      }
      if (sl == NSL - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < NQ; ++q) mma::add_to(acc[i][q], pt[i][q]);
      }
    }
  };

  // ---- the pipeline. The contraction warps produce: chunk q of X goes
  // to stage q % STAGES once the composers have released the stage's
  // last use (empty), and its copies complete the stage's full barrier.
  // The composers wait on full, compose, release the stage, write step
  // s's tile to W buffer s % 2 and meet the contraction warps at the
  // step barrier; after it the contraction warps contract that buffer
  // against x's tile of step s while the composers go on to step s + 1.
  // The contraction warps produce only up to STAGES chunks into the
  // next step before the step barrier, so neither side can wait on the
  // other in a cycle; the step barrier also tells the composers that the
  // contraction of step s - 1, the last reader of W buffer (s + 1) % 2,
  // is done.
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mma::mbar_init(full(st), NR);
      mma::mbar_init(empty(st), NR);
    }
    mma::mbar_init_fence();
  }
  __syncthreads();
  if (composer) {
    load_y();
    load_cache(s0);
    mma::cp_async_wait_all();
    bar_sync<BAR_COMPOSE, NR>();   // Y is in
    int q = 0;
    for (int s = s0; s < s1; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int t = 0; t < 2; ++t) cw[f][t][0] = cw[f][t][1] = cw[f][t][2] = cw[f][t][3] = 0.f;
      for (int ci = 0; ci < nrc; ++ci, ++q) {
        const int st = q % STAGES;
        mma::mbar_wait(full(st), (q / STAGES) & 1);
        compose_chunk(Xs + st * NF * BK * XST, ci * RC);
        mma::mbar_arrive(empty(st));
      }
      store_w(s & 1);
      load_cache(s + 1);
      bar_sync<BAR_STEP, NT>();
    }
    return;
  }
  // Each producing thread keeps its own count qp: the barriers count
  // threads, so one may run ahead of another.
  int qp = 0;   // the next chunk this thread produces
  auto produce = [&](int qe, bool block) {
    for (; qp < min(qe, total); ++qp) {
      const int st = qp % STAGES;
      const uint32_t parity = ((qp / STAGES) & 1) ^ 1;
      if (block) mma::mbar_wait(empty(st), parity);
      else if (!mma::mbar_test(empty(st), parity)) return;
      load_chunk(qp);
      mma::cp_async_arrive(full(st));
    }
  };
  for (int s = s0; s < s1; ++s) {
    load_x(s);
    produce((s - s0 + 1) * nrc + STAGES, true);
    mma::cp_async_wait_all();
    bar_sync<BAR_CONTRACT, NR>();   // x's tile is in
    bar_sync<BAR_STEP, NT>();       // and W's
    for (int sl = 0; sl < NSL; ++sl) {
      contract_slice(s & 1, sl);
      produce((s - s0 + 2) * nrc + STAGES, false);   // the stages freed meanwhile
    }
    bar_sync<BAR_CONTRACT, NR>();   // every contraction warp is done with x's tile
  }

  // ---- epilogue: acc[i][q][e] is out[row r0+8q+2c4+(e&1)][col 16i+g+8(e>>1)]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 16 * i + g + 8 * (e >> 1);
        const int row = r0 + 8 * qq + 2 * c4 + (e & 1);
        if (row < nr && col < n) {
          const size_t at = (cl * rows + row0 + row) * (size_t)n + col;
          float v = acc[i][qq][e];
          if (splits > 1) {
            ws[(size_t)split * gridDim.z * rows * n + at] = v;
          } else {
            if (op.scale != nullptr) v *= op.scale[col];
            y[at] = from_f<XT>(v);
          }
        }
      }
    }
  }
}

// y[i] = (Σ_p ws[p][i] over the splits, in order) · scale[i % n],
// cast to y's dtype; scale may be null. Four consecutive outputs a
// thread (16-byte loads) when total is a multiple of 4.
template <typename XT>
__global__ void __launch_bounds__(NR)
reduce_splits(const float* __restrict__ ws, XT* __restrict__ y,
              const float* __restrict__ scale, size_t total, int n, int splits) {
  const size_t first = blockIdx.x * (size_t)NR + threadIdx.x, stride = (size_t)gridDim.x * NR;
  if (total % 4 != 0) {
    for (size_t i = first; i < total; i += stride) {
      float v = 0.f;
#pragma unroll 8
      for (int p = 0; p < splits; ++p) v += ws[p * total + i];
      if (scale != nullptr) v *= scale[i % n];
      y[i] = from_f<XT>(v);
    }
    return;
  }
  for (size_t i = 4 * first; i < total; i += 4 * stride) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int p = 0; p < splits; ++p) {
      const float4 w = *reinterpret_cast<const float4*>(ws + p * total + i);
      v[0] += w.x;
      v[1] += w.y;
      v[2] += w.z;
      v[3] += w.w;
    }
    if (scale != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= scale[(i + e) % n];
    }
    if constexpr (sizeof(XT) == 2) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(y + i) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                                     *reinterpret_cast<const uint32_t*>(&b));
    } else {
      *reinterpret_cast<float4*>(y + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Launch the split-sum pass of a launch that split m; a no-op when
// splits == 1. Returns the cudaError_t.
template <typename XT>
inline cudaError_t sum_splits(const float* ws, XT* y, const float* scale, size_t total, int n,
                              int splits, cudaStream_t s) {
  if (splits == 1 || total == 0) return cudaSuccess;
  const size_t per = total % 4 == 0 ? 4 : 1;   // outputs a thread
  const unsigned nb = (unsigned)std::min<size_t>((total / per + NR - 1) / NR, 4096);
  reduce_splits<XT><<<nb, NR, 0, s>>>(ws, y, scale, total, n, splits);
  return cudaGetLastError();
}

// The fewest splits of m (>= 1) that fill the card's `slots` block
// slots, by a count of waves x steps per block (one step of overhead per
// block).
inline int pick_splits(long long blocks, int steps, long long slots) {
  int best = 1;
  long long best_cost = -1;
  for (int sp = 1; sp <= std::min(16, steps); ++sp) {
    const long long waves = (blocks * sp + slots - 1) / slots;
    const long long cost = waves * ((steps + sp - 1) / sp + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = sp;
    }
  }
  return best;
}

// Activation rows per block: 512 for bf16 prefill while its x tile fits
// beside the factors; 64 for one rank product at decode widths (two
// blocks per SM); else 128.
template <int NF>
inline int rows_per_block(int rows, int r, int x_dtype) {
  if (x_dtype == tiles::X_BF16 && rows > 128 &&
      smem_bytes<NF, __nv_bfloat16, 512>(r) <= (size_t)MAX_SMEM)
    return 512;
  if (NF == 1 && rows <= 64) return 64;
  return 128;
}

template <class Op, typename XT, int RMAX>
cudaError_t prepare(int r, size_t* smem) {
  *smem = smem_bytes<Op::NF, XT, RMAX>(r);
  // a rank too large leaves no room for the X ring
  if (*smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return tiles::allow_smem(fused_kernel<Op, XT, RMAX>, *smem);
}

template <class Op, typename XT, int RMAX>
int blocks_per_sm(int r) {
  size_t smem = 0;
  if (prepare<Op, XT, RMAX>(r, &smem) != cudaSuccess) return 1;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fused_kernel<Op, XT, RMAX>, NT,
                                                    smem) != cudaSuccess)
    return 1;
  return nb > 0 ? nb : 1;
}

// How many blocks split the m axis of a launch of Op (>= 1): the fewest
// that fill the card's `sms` multiprocessors. m is the contraction
// length and n the output width.
template <class Op>
int splits_for(int clients, int rows, int m, int n, int r, int x_dtype, int sms) {
  if (clients <= 0 || rows <= 0 || n <= 0 || m <= 0 || sms <= 0) return 1;
  const int rmax = rows_per_block<Op::NF>(rows, r, x_dtype);
  const bool f32 = x_dtype == tiles::X_F32;
  int per_sm = 1;
  if constexpr (Op::NF == 1) {
    if (rmax == 64)
      per_sm = f32 ? blocks_per_sm<Op, float, 64>(r) : blocks_per_sm<Op, __nv_bfloat16, 64>(r);
  }
  if (rmax == 512) per_sm = blocks_per_sm<Op, __nv_bfloat16, 512>(r);
  else if (rmax == 128)
    per_sm = f32 ? blocks_per_sm<Op, float, 128>(r) : blocks_per_sm<Op, __nv_bfloat16, 128>(r);
  const long long blocks = (long long)((n + BN - 1) / BN) * ((rows + rmax - 1) / rmax) * clients;
  return pick_splits(blocks, (m + BK - 1) / BK, (long long)sms * per_sm);
}

template <class Op, typename XT, int RMAX>
int launch_cfg(const Op& op, const void* x, void* y, void* ws, int clients, int rows, int m,
               int n, int r, int splits, cudaStream_t s) {
  size_t smem = 0;
  cudaError_t err = prepare<Op, XT, RMAX>(r, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long gy = (long long)((rows + RMAX - 1) / RMAX) * splits;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (unsigned)gy, clients);
  fused_kernel<Op, XT, RMAX><<<grid, NT, smem, s>>>(op, static_cast<const XT*>(x),
                                                    static_cast<XT*>(y),
                                                    static_cast<float*>(ws), rows, m, n, r,
                                                    splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_splits<XT>(static_cast<const float*>(ws), static_cast<XT*>(y), op.scale,
                             (size_t)clients * rows * n, n, splits, s);
}

// Launch Op for `clients` problems of (rows, m) activations of x_dtype
// (X_F32 | X_BF16; y has x's dtype). splits from splits_for; when > 1,
// ws is an fp32 workspace of splits x clients x rows x n. Returns the
// launch's cudaError_t (0 on success).
template <class Op>
int launch(const Op& op, const void* x, void* y, void* ws, int clients, int rows, int m, int n,
           int r, int x_dtype, int splits, cudaStream_t s) {
  if (clients <= 0 || rows <= 0 || n <= 0) return 0;
  if (clients > 65535 || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (x_dtype != tiles::X_F32 && x_dtype != tiles::X_BF16) return (int)cudaErrorInvalidValue;
  const int rmax = rows_per_block<Op::NF>(rows, r, x_dtype);
  if (x_dtype == tiles::X_F32) {
    if constexpr (Op::NF == 1)
      if (rmax == 64)
        return launch_cfg<Op, float, 64>(op, x, y, ws, clients, rows, m, n, r, splits, s);
    return launch_cfg<Op, float, 128>(op, x, y, ws, clients, rows, m, n, r, splits, s);
  }
  if constexpr (Op::NF == 1)
    if (rmax == 64)
      return launch_cfg<Op, __nv_bfloat16, 64>(op, x, y, ws, clients, rows, m, n, r, splits, s);
  if (rmax == 512)
    return launch_cfg<Op, __nv_bfloat16, 512>(op, x, y, ws, clients, rows, m, n, r, splits, s);
  return launch_cfg<Op, __nv_bfloat16, 128>(op, x, y, ws, clients, rows, m, n, r, splits, s);
}

}  // namespace fused
