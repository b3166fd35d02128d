// Fused FedPara backward: the factor gradients (K4), for sm_90a.
//
//   y = x · W,  W = f1(W1) ⊙ f2(W2),  W1 = X1 Y1ᵀ,  W2 = X2 Y2ᵀ
//   dW = xᵀ dy                                   (summed over the batch)
//   G1 = dW ⊙ f2(W2) ⊙ f1'(W1),  G2 = dW ⊙ f1(W1) ⊙ f2'(W2)
//   side x:  dX1 = G1 Y1,   dX2 = G2 Y2          (m x r each)
//   side y:  dY1 = G1ᵀ X1,  dY2 = G2ᵀ X2         (n x r each)
//
// Replaces (TPU, Pallas):
//   K4  src/repro/kernels/fedpara_grad.py:_dfactors_body  -> repro_fedpara_dfactors
//       (fedpara_dx_factors: side x; fedpara_dy_factors: side y), both
//       its 2-D form and its lead=True form with a leading client axis
//       (the batched FL engine's backward): `clients` independent
//       problems in one launch, client c (grid z) reading every operand
//       at its own slab of a contiguous (clients, ...) stack.
//
// One kernel serves both sides. Side y is side x of the transposed
// problem: dWᵀ = dyᵀ x, W1ᵀ = Y1 X1ᵀ, and the chain rule is elementwise,
// so dY1 = G1ᵀ X1 is what side x computes when (x, dy, X1, Y1, X2, Y2)
// are passed as (dy, x, Y1, X1, Y2, X2). The kernel knows only the
// "own" axis P (the output rows: m for side x, n for side y, factors F)
// and the "other" axis Q it sweeps (activations D, factors H):
//   A (B, P), D (B, Q), F1, F2 (P, r), H1, H2 (Q, r) -> O1, O2 (P, r).
// Two launches per backward, one per side, as the reference makes (its
// :27-32 explain why fusing them costs more than recomputing dW).
//
// What bounds it on an H100: operations. Per (P x Q) weight element it
// takes 2·B for dW (bf16 or 3xTF32), 4·r for the two rank-r composes
// and 4·r for the two contractions, both in 3xTF32 (the factors and G
// are fp32 in the reference); the (P x Q) dW, W and G never reach
// device memory. The design (the TPU kernel carried dW and the (bm, r)
// sums across sequential grid steps; Hopper has no sequential grid):
//   * a block of 16 warps owns BP = 32 output rows (16 when the rank is
//     above 256) and every rank column, and sweeps Q in steps of BQ = 32
//     columns, each block starting at its own tile (so that the blocks
//     read different H and D tiles at any moment). Its F rows (BP x r,
//     both factors) are loaded once, and each step's H tile (BQ x r,
//     both factors) once, into shared memory: every H row by 16-byte
//     copies placed at the row's own alignment (an odd r leaves rows at
//     any 4-byte offset), the rank padded to a multiple of 8. That one H
//     tile is the B operand of the compose F·Hᵀ and of the contraction
//     G·H;
//   * dW (BP x BQ, contracted over the batch) on the tensor cores: bf16
//     m16n8k16 with ldmatrix.trans for both operands (A and D are
//     stored [batch][column]), 3xTF32 m16n8k8 for fp32 activations. A
//     and D stream through a cp.async ring of batch chunks (3 stages;
//     2 at 16 own rows); warp w sums 16 own rows x 32 columns over its
//     k step of each chunk (fresh registers per chunk), and the G warps
//     add the 16 / PT slices in warp order;
//   * W1, W2: warp w composes one factor's 16 x 32 tile over a part of
//     the rank in 3xTF32 (every fp32 operand split into TF32 hi and lo
//     halves, csrc/mma.cuh; an F fragment serves four MMA tiles), each
//     rank chunk of 32 in fresh registers, added on the CUDA cores: the
//     tensor core's fp32 accumulator truncates;
//   * G1, G2: warp w < 4 PT adds the partial dW and W tiles of one MMA
//     tile in a fixed order through shared memory, forms G in
//     registers and stores it as TF32 hi/lo halves;
//   * the contraction: warp (factor, 16 own rows, a part of the rank
//     columns) adds G·H in 3xTF32, each step's contribution in fresh
//     registers, then to the running sums on the CUDA cores;
//   * 16 warps (not 8) so that each holds half the accumulators (128
//     registers, no spills) and a scheduler has four warps whose
//     latencies to hide behind each other: faster on the card than 8
//     warps of 200 registers. The loads and the tensor-core work of a
//     step still take turns (PERF.md section 6);
//   * where the output rows give too few blocks for the card (side y of
//     a 1024-wide projection, a few clients of a small layer), the sweep
//     is split over grid y and a second kernel sums the partial outputs
//     in a fixed order: no atomics, so two launches give the same bits;
//   * every ragged edge (batch, P, Q, r) and unaligned pointer is masked
//     in the kernel: zero-filled copies, plain loads where an activation
//     row is not 16-byte aligned;
//   * ranks up to 336 stage F and H in shared memory. Above that (γ =
//     0.3 gives r = 505 at qwen3-8b's MLP widths) the large-rank form
//     (block_form: M_GLOBAL) stages neither: its compose and contraction
//     warps read their F and H fragments from global memory (L1, L2),
//     masked, and the output's rank is split over blocks of 512 columns
//     on grid y (beside the sweep's splits), each recomputing dW and the
//     full-rank W tiles. Same arithmetic, any rank; slower per rank.
// Registers and spills (nvcc -Xptxas -v) and the dynamic shared memory
// (repro_dfactors_smem_bytes) are printed by chip_smoke.py's phase 1.
#include <algorithm>

#include "fused.cuh"

using tiles::X_BF16;
using tiles::X_F32;

namespace {

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };

constexpr int NT = 512;          // 16 warps
constexpr int NW = NT / 32;
constexpr int BQ = 32;           // other-axis columns per sweep step (4 n8 tiles)
constexpr int NJ = 8;            // rank n8 tiles a contraction warp holds at most
constexpr int RC = 32;           // rank columns per fresh compose run
constexpr int GS = BQ + 4;       // G row stride (words): conflict-free A fragments
constexpr int DS = BQ + 8;       // D chunk row stride (elements)
constexpr int MAX_SMEM = fused::MAX_SMEM;

using fused::pad_rank;
using fused::y_stride;

// Batch rows per ring chunk: one MMA k step (16 bf16 rows, 8 fp32) for
// each of the NW / PT warps that share an own-row tile.
template <typename XT, int PT> __host__ __device__ constexpr int chunk_rows() {
  return (sizeof(XT) == 2 ? 16 : 8) * (NW / PT);
}
// A chunk row stride (elements): the rows of a bf16 8 x 8 ldmatrix land
// in distinct 16-byte segments; fp32 fragments in distinct banks.
template <int PT> __host__ __device__ constexpr int a_stride() { return 16 * PT + 8; }
// H tile row stride (floats): a row of r values placed at its global
// alignment (shift 0-3, so that 16-byte copies land aligned), the rank
// padding after it, 8 mod 16 against bank conflicts.
__host__ __device__ constexpr int h_stride(int r) {
  return ((pad_rank(r) + 4 + 7) & ~7) % 16 == 0 ? ((pad_rank(r) + 4 + 7) & ~7) + 8
                                                 : (pad_rank(r) + 4 + 7) & ~7;
}

// Shared-memory layout of one block (bytes), for PT p16 tiles of own
// rows (BP = 16 PT) and rank r. The union holds the dW partial tiles,
// then the W partial tiles, then G. GF (factors from global memory, the
// large-rank form) stages no F rows and no H tile.
template <typename XT, int PT, bool GF = false>
struct Layout {
  static constexpr int BP = 16 * PT;
  static constexpr int ST = PT == 2 ? 3 : 2;                    // stages of the A / D ring
  static constexpr int PARTIALS = NW * 4 * 32 * 4 * 4;          // 16 warps' 16 x 32 tiles
  static constexpr int GBYTES = 2 * 2 * BP * GS * 4;            // G1, G2 as hi, lo
  static constexpr int UNION = PARTIALS > GBYTES ? PARTIALS : GBYTES;
  static constexpr int STAGE = chunk_rows<XT, PT>() * (a_stride<PT>() + DS) * (int)sizeof(XT);
  __host__ __device__ static size_t h_off(int r) { return GF ? 0 : 4ull * 2 * BP * y_stride(r); }   // after F
  __host__ __device__ static size_t u_off(int r) {
    return GF ? 0 : h_off(r) + 4ull * 2 * BQ * h_stride(r);
  }
  __host__ __device__ static size_t ring_off(int r) { return u_off(r) + UNION; }
  __host__ __device__ static size_t bar_off(int r) { return ring_off(r) + (size_t)ST * STAGE; }
  __host__ __device__ static size_t bytes(int r) { return bar_off(r) + 8; }
};

// Rank n8 tiles the contraction warps of a block hold: 32 at two
// own-row tiles, 64 (512 ranks) at one.
__host__ __device__ constexpr int rank_tiles(int PT) { return (NW / 2 / PT) * NJ; }
// Whether rank r fits a launch of PT own-row tiles with F and H staged.
template <typename XT, int PT>
inline bool fits(int r) {
  return Layout<XT, PT>::bytes(r) <= (size_t)MAX_SMEM && pad_rank(r) <= rank_tiles(PT) * 8;
}
// The block form for rank r: M_PT2, two own-row tiles (32 rows) while
// the shared memory holds them; M_PT1, one (16 rows; the rank split over
// more contraction warps); M_GLOBAL above that (r > 336), one own-row
// tile reading F and H from global memory (L1 and L2) and the output's
// rank split over blocks of 512 columns, each of which recomputes dW and
// the full-rank W tiles.
enum { M_GLOBAL = 0, M_PT1 = 1, M_PT2 = 2 };
template <typename XT>
inline int block_form(int r) {
  if (fits<XT, 2>(r)) return M_PT2;
  return fits<XT, 1>(r) ? M_PT1 : M_GLOBAL;
}
inline int rank_blocks(int form, int r) {
  return form == M_GLOBAL ? (pad_rank(r) / 8 + rank_tiles(1) - 1) / rank_tiles(1) : 1;
}

template <typename XT, int KIND, int PT, bool GF>
__global__ void __launch_bounds__(NT, 1)
dfactors_kernel(const XT* __restrict__ A, const XT* __restrict__ D,
                const float* __restrict__ F1, const float* __restrict__ F2,
                const float* __restrict__ H1, const float* __restrict__ H2,
                float* __restrict__ O1, float* __restrict__ O2, int B, int P, int Q, int r,
                int splits) {
  using L = Layout<XT, PT, GF>;
  static_assert(!GF || PT == 1, "the large-rank form has one own-row tile");
  constexpr int ST = L::ST;
  constexpr bool BF16 = sizeof(XT) == 2;
  constexpr int BP = L::BP;
  constexpr int BB = chunk_rows<XT, PT>();
  constexpr int AS = a_stride<PT>();
  constexpr int VX = 16 / sizeof(XT);      // activation values per 16-byte copy
  constexpr int NS = NW / PT;              // batch slices of a chunk (dW warps per own-row tile)
  constexpr int KSTEP = BF16 ? 16 : 8;     // MMA k
  constexpr int KPS = BB / NS / KSTEP;     // k steps per slice
  constexpr int NH = NW / (2 * PT);        // rank parts of the compose
  constexpr int RP = NW / 2 / PT;          // rank parts of the contraction
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int p0 = blockIdx.x * BP;
  const size_t cl = blockIdx.z;
  A += cl * B * P;
  D += cl * B * Q;
  F1 += cl * P * r;
  F2 += cl * P * r;
  H1 += cl * Q * r;
  H2 += cl * Q * r;

  const int RPD = pad_rank(r), ys = y_stride(r), hs = h_stride(r);
  // grid y: the split of the Q sweep, then (GF) the output's rank block
  const int split = (int)(blockIdx.y % splits), rblk = (int)(blockIdx.y / splits);
  const int nq = (Q + BQ - 1) / BQ;
  const int t_lo = (int)((long long)nq * split / splits);
  const int t_hi = (int)((long long)nq * (split + 1) / splits);
  const int nsteps = t_hi - t_lo;
  // blocks start their sweeps at different tiles, so that at any moment
  // they read different H and D tiles (L2 slices) rather than one
  const int rot = nsteps > 0 ? (int)(blockIdx.x % nsteps) : 0;
  auto tile = [&](int t) { return t_lo + (t + rot) % nsteps; };
  const int nch = max(1, (B + BB - 1) / BB);
  const int total = nsteps * nch;             // ring chunks of this block

  float* Fs = reinterpret_cast<float*>(smem);                       // [2][BP][ys]
  float* Hs = reinterpret_cast<float*>(smem + L::h_off(r));         // [2][BQ][hs]
  float* dwp = reinterpret_cast<float*>(smem + L::u_off(r));        // [NS][PT][4][32][4]
  float* wp = dwp;                                                  // [2][NH][PT][4][32][4]
  uint32_t* Gs = reinterpret_cast<uint32_t*>(smem + L::u_off(r));   // [2][hi, lo][BP][GS]
  unsigned char* ring = smem + L::ring_off(r);
  const uint32_t hbar = mma::smem_u32(smem + L::bar_off(r));   // the H tile's arrival
  auto astage = [&](int st) { return reinterpret_cast<XT*>(ring + (size_t)st * L::STAGE); };
  auto dstage = [&](int st) { return astage(st) + BB * AS; };
  const float* const Hg[2] = {H1, H2};
  // the float offset (0-3) of a factor row's start within its 16 bytes:
  // element (q, k) of factor f's H tile is at Hs[f][q][hshift + k]
  const int hb[2] = {(int)((reinterpret_cast<uintptr_t>(H1) >> 2) & 3),
                     (int)((reinterpret_cast<uintptr_t>(H2) >> 2) & 3)};
  auto hshift = [&](int f, int q0, int q) { return (int)(((long long)(q0 + q) * r + hb[f]) & 3); };

  // ---- loaders (every thread issues its share, zero fill outside)
  // F rows p0.. into [rows][ys], columns r..RPD-1 as zeros; copies of
  // 4, 2 or 1 floats as r and the pointers allow (once per block)
  const uintptr_t fbits = (uintptr_t)F1 | (uintptr_t)F2;
  const int fv = r % 4 == 0 && fbits % 16 == 0 ? 4 : r % 2 == 0 && fbits % 8 == 0 ? 2 : 1;
  auto load_f = [&](float* dst, const float* src) {
    const int per = RPD / fv;
    for (int i = tid; i < BP * per; i += NT) {
      const int rr = i / per, j = (i % per) * fv;
      const bool ok = p0 + rr < P && j < r;
      const float* sp = src + (size_t)(p0 + rr) * r + j;
      float* d = dst + rr * ys + j;
      if (fv == 4) mma::cp_async_f<4>(d, sp, ok);
      else if (fv == 2) mma::cp_async_f<2>(d, sp, ok);
      else mma::cp_async_f<1>(d, sp, ok);
    }
  };
  // the H tile of step t: each row's r values by
  // 16-byte copies at the row's own alignment (4-byte copies for the
  // partial vectors at its ends); rows past Q are left as they are
  // (finite: zeros or an earlier tile's), and G is zero there
  const int vpr = (r + 3 + 3) / 4;          // vectors a row spans at most
  auto load_h = [&](int t) {
    const int q0 = tile(t) * BQ;
    for (int i = tid; i < 2 * BQ * vpr; i += NT) {
      const int f = i / (BQ * vpr), q = (i / vpr) % BQ, v = i % vpr;
      if (q0 + q >= Q) continue;
      const int sh = hshift(f, q0, q);
      const float* row = Hg[f] + (size_t)(q0 + q) * r;
      float* d = Hs + (f * BQ + q) * hs + 4 * v;          // holds row elements 4v - sh ..
      const int k = 4 * v - sh;
      if (k >= 0 && k + 4 <= r) {
        mma::cp_async16(d, row + k, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e >= 0 && k + e < r) mma::cp_async4(d + e, row + k + e, true);
      }
    }
    mma::cp_async_arrive(hbar);
  };
  // ring chunk ci (step ci / nch, batch rows (ci % nch) * BB..) into stage st
  const bool avec = P % VX == 0 && tiles::aligned16(A);
  const bool dvec = Q % VX == 0 && tiles::aligned16(D);
  auto load_chunk = [&](int ci, int st) {
    const int b0 = (ci % nch) * BB, q0 = tile(ci / nch) * BQ;
    auto copy = [&](XT* dst, const XT* src, int stride, int cols, int c0, int lim, bool vec) {
      const int per = cols / VX;
      for (int i = tid; i < BB * per; i += NT) {
        const int row = i / per, col = (i % per) * VX, b = b0 + row;
        XT* d = dst + row * stride + col;
        const XT* s = src + (size_t)b * lim + c0 + col;
        if (vec) {
          mma::cp_async16(d, s, b < B && c0 + col < lim);
        } else if constexpr (!BF16) {
#pragma unroll
          for (int e = 0; e < VX; ++e)
            mma::cp_async4(d + e, s + e, b < B && c0 + col + e < lim);
        } else {
#pragma unroll
          for (int e = 0; e < VX; ++e)
            d[e] = b < B && c0 + col + e < lim ? s[e] : fused::zero_of<XT>();
        }
      }
    };
    copy(astage(st), A, AS, BP, p0, P, avec);
    copy(dstage(st), D, DS, BQ, q0, Q, dvec);
  };

  // ---- dW: warp w sums own-row tile dpi = w % PT (16 rows x all BQ
  // columns: 4 MMA tiles) over batch slice dsl = w / PT of each chunk
  // (KPS k steps); a chunk's sum is fresh, then added on the CUDA cores
  const int dpi = warp % PT, dsl = warp / PT;
  float dw[4][4];
  auto dw_chunk = [&](int st) {
    float dwf[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dwf[i][0] = dwf[i][1] = dwf[i][2] = dwf[i][3] = 0.f;
    const XT* As = astage(st);
    const XT* Ds = dstage(st);
#pragma unroll
    for (int ks = 0; ks < KPS; ++ks) {
      const int k0 = (dsl * KPS + ks) * KSTEP;
      if constexpr (BF16) {
        uint32_t a[4], b[4][2];
        mma::ldsm_x4_trans(a, As + (k0 + (lane & 7) + 8 * (lane >> 4)) * AS + 16 * dpi +
                                  8 * ((lane >> 3) & 1));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t t4[4];
          mma::ldsm_x4_trans(t4, Ds + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS + 16 * np +
                                     8 * (lane >> 4));
          b[2 * np][0] = t4[0];
          b[2 * np][1] = t4[1];
          b[2 * np + 1][0] = t4[2];
          b[2 * np + 1][1] = t4[3];
        }
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) mma::mma_bf16(dwf[qj], a, b[qj]);
      } else {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        const float* ar = reinterpret_cast<const float*>(As) + 16 * dpi + g;
        mma::split(ar[(k0 + c) * AS], ah[0], al[0]);
        mma::split(ar[(k0 + c) * AS + 8], ah[1], al[1]);
        mma::split(ar[(k0 + c + 4) * AS], ah[2], al[2]);
        mma::split(ar[(k0 + c + 4) * AS + 8], ah[3], al[3]);
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) {
          const float* dr = reinterpret_cast<const float*>(Ds) + 8 * qj + g;
          mma::split(dr[(k0 + c) * DS], bh[qj][0], bl[qj][0]);
          mma::split(dr[(k0 + c + 4) * DS], bh[qj][1], bl[qj][1]);
        }
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) mma::mma_pass<0>(dwf[qj], ah, al, bh[qj], bl[qj]);
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) mma::mma_pass<1>(dwf[qj], ah, al, bh[qj], bl[qj]);
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) mma::mma_pass<2>(dwf[qj], ah, al, bh[qj], bl[qj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma::add_to(dw[i], dwf[i]);
  };

  // ---- compose: warp w composes factor cf = w & 1, own rows 16 cpi + g
  // (+8), cpi = (w >> 1) % PT, every BQ column (4 MMA tiles), over rank
  // part cpart = (w >> 1) / PT of NH; its partial W goes to shared
  // memory and the G warps add the parts. The MMA's k index c maps to
  // rank column 2c and c + 4 to 2c + 1 of each group of 8 (mma.cuh), so
  // F fragments are float2 loads.
  const int cf = warp & 1, cpi = (warp >> 1) % PT, cpart = (warp >> 1) / PT;
  const int nk8 = RPD / 8, kper = (nk8 + NH - 1) / NH;
  const int kb0 = cpart * kper, kn = max(0, min(nk8, kb0 + kper) - kb0);
  auto compose = [&](int q0) {
    float wsum[4][4], pc[4][4];
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
#pragma unroll
      for (int e = 0; e < 4; ++e) wsum[qj][e] = pc[qj][e] = 0.f;
    const float* Fr = Fs + (cf * BP + 16 * cpi + g) * ys + 8 * kb0 + 2 * c;
    const float* Hr[4];
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
      Hr[qj] = Hs + (cf * BQ + 8 * qj + g) * hs + hshift(cf, q0, 8 * qj + g) + 8 * kb0 + 2 * c;
    // GF: the same operands from global memory, zero outside P, Q and r
    const int fp = p0 + 16 * cpi + g;
    const float* Fgr = (cf ? F2 : F1) + (size_t)fp * r;
    const float* Hgr[4];
#pragma unroll
    for (int qj = 0; qj < 4; ++qj) Hgr[qj] = Hg[cf] + (size_t)(q0 + 8 * qj + g) * r;
    auto gpair = [&](const float* row, bool ok, int col) {
      return make_float2(ok && col < r ? __ldg(row + col) : 0.f,
                         ok && col + 1 < r ? __ldg(row + col + 1) : 0.f);
    };
#pragma unroll 2
    for (int k = 0; k < kn; ++k) {
      uint32_t ah[4], al[4];
      const int col = 8 * (kb0 + k) + 2 * c;
      const float2 ya = GF ? gpair(Fgr, fp < P, col)
                           : *reinterpret_cast<const float2*>(Fr + 8 * k);
      const float2 yb = GF ? gpair(Fgr + 8 * (size_t)r, fp + 8 < P, col)
                           : *reinterpret_cast<const float2*>(Fr + 8 * ys + 8 * k);
      mma::split(ya.x, ah[0], al[0]);
      mma::split(yb.x, ah[1], al[1]);
      mma::split(ya.y, ah[2], al[2]);
      mma::split(yb.y, ah[3], al[3]);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) {
        const float2 hv = GF ? gpair(Hgr[qj], q0 + 8 * qj + g < Q, col)
                             : make_float2(Hr[qj][8 * k], Hr[qj][8 * k + 1]);
        mma::split(hv.x, bh[qj][0], bl[qj][0]);
        mma::split(hv.y, bh[qj][1], bl[qj][1]);
      }
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) mma::mma_pass<0>(pc[qj], ah, al, bh[qj], bl[qj]);
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) mma::mma_pass<1>(pc[qj], ah, al, bh[qj], bl[qj]);
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) mma::mma_pass<2>(pc[qj], ah, al, bh[qj], bl[qj]);
      if (k % (RC / 8) == RC / 8 - 1 || k + 1 == kn) {   // a rank chunk ends
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) mma::add_to(wsum[qj], pc[qj]);
      }
    }
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
      reinterpret_cast<float4*>(wp)[(((cf * NH + cpart) * PT + cpi) * 4 + qj) * 32 + lane] =
          make_float4(wsum[qj][0], wsum[qj][1], wsum[qj][2], wsum[qj][3]);
  };

  // ---- G: warp w < 4 PT owns MMA tile (gpi, gqj) = (w / 4, w % 4): own
  // rows 16 gpi + g (+8), columns 8 gqj + 2c (+1); it adds the partial
  // dW and W tiles in a fixed order
  const bool gwarp = warp < 4 * PT;
  const int gpi = warp / 4, gqj = warp % 4;

  // ---- contraction: warp (f, pi, part) holds own rows 16 pi + g (+8)
  // of factor f and the rank n8 tiles [jt0, jt0 + jn) of this block's
  // rank block (tiles tb0..); the MMA's k index c maps to column c and
  // c + 4 to column c + 4 of each 8 of the step
  const int kf = warp / (NW / 2), kpi = (warp % (NW / 2)) / RP, kpart = warp % RP;
  const int tb0 = rblk * rank_tiles(PT);
  const int ntiles = min(rank_tiles(PT), RPD / 8 - tb0), per = (ntiles + RP - 1) / RP;
  const int jt0 = tb0 + kpart * per, jn = max(0, min(per, tb0 + ntiles - jt0));
  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  auto contract = [&](int q0) {
    float of[NJ][4];   // this step's contribution, fresh
#pragma unroll
    for (int j = 0; j < NJ; ++j) of[j][0] = of[j][1] = of[j][2] = of[j][3] = 0.f;
    const uint32_t* gh = Gs + (kf * 2 * BP + 16 * kpi) * GS;
    const uint32_t* gl = gh + BP * GS;
    const float* Hf = Hs + kf * BQ * hs + 8 * jt0 + g;
#pragma unroll
    for (int k8 = 0; k8 < BQ / 8; ++k8) {
      const int q = 8 * k8 + c;
      const uint32_t ah[4] = {gh[g * GS + q], gh[(g + 8) * GS + q], gh[g * GS + q + 4],
                              gh[(g + 8) * GS + q + 4]};
      const uint32_t al[4] = {gl[g * GS + q], gl[(g + 8) * GS + q], gl[g * GS + q + 4],
                              gl[(g + 8) * GS + q + 4]};
      const float* h0 = Hf + q * hs + hshift(kf, q0, q);
      const float* h1 = Hf + (q + 4) * hs + hshift(kf, q0, q + 4);
      // GF: rows q0 + q (+4) of H from global memory, zero outside Q and r
      const float* g0 = Hg[kf] + (size_t)(q0 + q) * r + 8 * jt0 + g;
      const float* g1 = g0 + 4 * (size_t)r;
      const bool v0 = q0 + q < Q, v1 = q0 + q + 4 < Q;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < jn) {
          uint32_t bh[2], bl[2];
          const bool cv = 8 * (jt0 + j) + g < r;
          mma::split(GF ? (v0 && cv ? __ldg(g0 + 8 * j) : 0.f) : h0[8 * j], bh[0], bl[0]);
          mma::split(GF ? (v1 && cv ? __ldg(g1 + 8 * j) : 0.f) : h1[8 * j], bh[1], bl[1]);
          mma::mma_pass<0>(of[j], ah, al, bh, bl);
          mma::mma_pass<1>(of[j], ah, al, bh, bl);
          mma::mma_pass<2>(of[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma::add_to(o[j], of[j]);
  };

  // ---- the sweep
  if constexpr (!GF) {
    for (int i = tid; i < 2 * BQ * hs; i += NT) Hs[i] = 0.f;   // finite before any copy
    if (tid == 0) {
      mma::mbar_init(hbar, NT);
      mma::mbar_init_fence();
    }
    __syncthreads();
    load_f(Fs, F1);
    load_f(Fs + BP * ys, F2);
    if (nsteps > 0) load_h(0);   // its arrival also covers F's copies
  }
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < total) load_chunk(i, i);
    mma::cp_async_commit();
  }
  int ci = 0;
  for (int t = 0; t < nsteps; ++t) {
    const int q0 = tile(t) * BQ;
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[i][0] = dw[i][1] = dw[i][2] = dw[i][3] = 0.f;
    for (int k = 0; k < nch; ++k, ++ci) {
      mma::cp_async_wait<ST - 2>();
      __syncthreads();   // chunk ci is in; every warp is done with ci - 1's stage
      if (ci + ST - 1 < total) load_chunk(ci + ST - 1, (ci + ST - 1) % ST);
      mma::cp_async_commit();
      dw_chunk(ci % ST);
    }
    // this warp's partial dW tiles: [slice][tile dpi][qj][lane][4]
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
      reinterpret_cast<float4*>(dwp)[((dsl * PT + dpi) * 4 + qj) * 32 + lane] =
          make_float4(dw[qj][0], dw[qj][1], dw[qj][2], dw[qj][3]);
    if constexpr (!GF) mma::mbar_wait(hbar, t & 1);   // H of this step landed
    __syncthreads();
    float dsum[4] = {0.f, 0.f, 0.f, 0.f}, w1[4] = {0.f, 0.f, 0.f, 0.f}, w2[4] = {0.f, 0.f, 0.f, 0.f};
    if (gwarp) {
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        const float4 v = reinterpret_cast<const float4*>(dwp)[((sl * PT + gpi) * 4 + gqj) * 32 + lane];
        dsum[0] += v.x;
        dsum[1] += v.y;
        dsum[2] += v.z;
        dsum[3] += v.w;
      }
    }
    __syncthreads();   // the dW partials are read: the W partials may overwrite them
    compose(q0);
    __syncthreads();   // the partial W tiles are in
    if (gwarp) {
#pragma unroll
      for (int pt = 0; pt < NH; ++pt) {
        const float4 a = reinterpret_cast<const float4*>(wp)[(((0 * NH + pt) * PT + gpi) * 4 + gqj) * 32 + lane];
        const float4 b = reinterpret_cast<const float4*>(wp)[(((1 * NH + pt) * PT + gpi) * 4 + gqj) * 32 + lane];
        w1[0] += a.x; w1[1] += a.y; w1[2] += a.z; w1[3] += a.w;
        w2[0] += b.x; w2[1] += b.y; w2[2] += b.z; w2[3] += b.w;
      }
    }
    __syncthreads();   // every partial is read: G may overwrite them
    if (gwarp) {
      // G1, G2 (fedpara_grad.py:_tile_factor_grads) at C-fragment entry
      // e: own row 16 gpi + g + 8 (e >> 1), column 8 gqj + 2c + (e & 1)
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * gpi + g + 8 * (e >> 1), q = 8 * gqj + 2 * c + (e & 1);
        float g1, g2;
        if (KIND == K_TANH) {
          const float t1 = tanhf(w1[e]), t2 = tanhf(w2[e]);
          g1 = dsum[e] * t2 * (1.f - t1 * t1);
          g2 = dsum[e] * t1 * (1.f - t2 * t2);
        } else {
          g1 = dsum[e] * (KIND == K_PFEDPARA ? w2[e] + 1.f : w2[e]);
          g2 = dsum[e] * w1[e];
        }
        const bool in = p0 + p < P && q0 + q < Q;
        mma::split(in ? g1 : 0.f, hi[0][e], lo[0][e]);
        mma::split(in ? g2 : 0.f, hi[1][e], lo[1][e]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* gp = Gs + (f * 2 * BP + 16 * gpi + g + 8 * h) * GS + 8 * gqj + 2 * c;
          *reinterpret_cast<uint2*>(gp) = make_uint2(hi[f][2 * h], hi[f][2 * h + 1]);
          *reinterpret_cast<uint2*>(gp + BP * GS) = make_uint2(lo[f][2 * h], lo[f][2 * h + 1]);
        }
    }
    __syncthreads();   // G is in
    contract(q0);
    __syncthreads();   // every warp is done with H and G
    if constexpr (!GF)
      if (t + 1 < nsteps) load_h(t + 1);
  }
  mma::cp_async_wait_all();

  // ---- write this block's sums (split y's partials when the sweep is
  // split): layout (splits, clients, P, r); o[j][e] is own row 16 kpi +
  // g + 8 (e >> 1), rank column 8 (jt0 + j) + 2c + (e & 1)
  float* out = (kf == 0 ? O1 : O2) +
               (splits > 1 ? ((size_t)split * gridDim.z + cl) * P * r : cl * P * r);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= jn) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 16 * kpi + g + 8 * (e >> 1);
      const int col = 8 * (jt0 + j) + 2 * c + (e & 1);
      if (p < P && col < r) out[(size_t)p * r + col] = o[j][e];
    }
  }
}

// out_f[i] = Σ_s part[f][s][i], in split order (deterministic).
__global__ void __launch_bounds__(NT)
sum_splits(const float* __restrict__ part, float* __restrict__ o1, float* __restrict__ o2,
           int splits, long long count) {
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < 2 * count;
       i += (long long)gridDim.x * NT) {
    const long long f = i / count, j = i % count;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < splits; ++k) s += part[(f * splits + k) * count + j];
    (f == 0 ? o1 : o2)[j] = s;
  }
}

struct Args {
  const void *a, *d, *f1, *f2, *h1, *h2;
  int clients, batch, P, Q, r, splits;
};

template <typename XT, int KIND, int PT, bool GF>
int launch(const Args& g, float* o1, float* o2, cudaStream_t s) {
  const size_t smem = Layout<XT, PT, GF>::bytes(g.r);
  auto k = dfactors_kernel<XT, KIND, PT, GF>;
  cudaError_t err = tiles::allow_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  const long long gy = (long long)g.splits * rank_blocks(GF ? M_GLOBAL : PT, g.r);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((g.P + 16 * PT - 1) / (16 * PT), (unsigned)gy, g.clients);
  k<<<grid, NT, smem, s>>>(static_cast<const XT*>(g.a), static_cast<const XT*>(g.d),
                           static_cast<const float*>(g.f1), static_cast<const float*>(g.f2),
                           static_cast<const float*>(g.h1), static_cast<const float*>(g.h2), o1,
                           o2, g.batch, g.P, g.Q, g.r, g.splits);
  return (int)cudaGetLastError();
}

template <typename XT, int KIND>
int launch_form(const Args& g, float* o1, float* o2, cudaStream_t s) {
  switch (block_form<XT>(g.r)) {
    case M_PT2: return launch<XT, KIND, 2, false>(g, o1, o2, s);
    case M_PT1: return launch<XT, KIND, 1, false>(g, o1, o2, s);
    default: return launch<XT, KIND, 1, true>(g, o1, o2, s);
  }
}

template <typename XT>
int launch_kind(int kind, const Args& g, float* o1, float* o2, cudaStream_t s) {
  switch (kind) {
    case K_FEDPARA: return launch_form<XT, K_FEDPARA>(g, o1, o2, s);
    case K_TANH: return launch_form<XT, K_TANH>(g, o1, o2, s);
    case K_PFEDPARA: return launch_form<XT, K_PFEDPARA>(g, o1, o2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT>
size_t smem_for(int r) {
  switch (block_form<XT>(r)) {
    case M_PT2: return Layout<XT, 2>::bytes(r);
    case M_PT1: return Layout<XT, 1>::bytes(r);
    default: return Layout<XT, 1, true>::bytes(r);
  }
}

template <typename XT, int PT, bool GF>
int occupancy(int r) {
  const size_t smem = Layout<XT, PT, GF>::bytes(r);
  int nb = 0;
  cudaError_t err = tiles::allow_smem(dfactors_kernel<XT, K_FEDPARA, PT, GF>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, dfactors_kernel<XT, K_FEDPARA, PT, GF>,
                                                        NT, smem);
  return err == cudaSuccess && nb > 0 ? nb : 1;
}

template <typename XT>
int blocks_per_sm(int r) {
  switch (block_form<XT>(r)) {
    case M_PT2: return occupancy<XT, 2, false>(r);
    case M_PT1: return occupancy<XT, 1, false>(r);
    default: return occupancy<XT, 1, true>(r);
  }
}

}  // namespace

extern "C" {

// How many blocks share one output slab's sweep for `clients` (own P,
// other Q, rank r, activations x_dtype) problems on a card with `sms`
// SMs: the fewest splits of the Q sweep (at most 16, at least one
// 32-column tile each) that fill the card, by a count of waves x steps
// per block (fused.cuh's pick_splits). With more than one,
// repro_fedpara_dfactors needs 2 x splits x clients x P x r fp32 of
// scratch.
int repro_dfactors_splits(int clients, int P, int Q, int r, int x_dtype, int sms) {
  if (clients <= 0 || P <= 0 || Q <= 0 || r <= 0 || sms <= 0) return 1;
  const bool f32 = x_dtype == X_F32;
  const int form = f32 ? block_form<float>(r) : block_form<__nv_bfloat16>(r);
  const int pt = form == M_PT2 ? 2 : 1;
  const int per_sm = f32 ? blocks_per_sm<float>(r) : blocks_per_sm<__nv_bfloat16>(r);
  const long long blocks =
      (long long)clients * ((P + 16 * pt - 1) / (16 * pt)) * rank_blocks(form, r);
  return fused::pick_splits(blocks, (Q + BQ - 1) / BQ, (long long)sms * per_sm);
}

// The dynamic shared memory in bytes of one K4 block at rank r
// (ptxas reports static shared memory only); -1 for an unknown dtype.
int repro_dfactors_smem_bytes(int r, int x_dtype) {
  if (x_dtype == X_F32) return (int)smem_for<float>(r);
  if (x_dtype == X_BF16) return (int)smem_for<__nv_bfloat16>(r);
  return -1;
}

// K4: O1, O2 (clients, P, r) fp32 = the factor gradients of one side
// for each client (see the top of this file): side x passes (x, dy, X1,
// X2, Y1, Y2) with P = m, Q = n; side y passes (dy, x, Y1, Y2, X1, X2)
// with P = n, Q = m. a (clients, batch, P) and d (clients, batch, Q)
// share x_dtype (X_F32 | X_BF16); the factors (clients, P, r) /
// (clients, Q, r) are fp32; clients = 1 is the 2-D form. kind: 0
// fedpara | 1 fedpara_tanh | 2 pfedpara. splits from
// repro_dfactors_splits; scratch (2 x splits x clients x P x r fp32) is
// read only when splits > 1. Returns the first cudaError_t (0 on
// success).
int repro_fedpara_dfactors(const void* a, const void* d, const void* f1, const void* f2,
                           const void* h1, const void* h2, void* o1, void* o2,
                           void* scratch, int clients, int batch, int P, int Q, int r,
                           int splits, int kind, int x_dtype, void* stream) {
  if (clients <= 0 || P <= 0 || r <= 0) return 0;
  if (clients > 65535 || splits < 1 || splits > 65535 || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args g{a, d, f1, f2, h1, h2, clients, batch, P, Q, r, splits};
  const long long count = (long long)clients * P * r;
  float* out1 = static_cast<float*>(splits > 1 ? scratch : o1);
  float* out2 = splits > 1 ? static_cast<float*>(scratch) + splits * count
                           : static_cast<float*>(o2);
  int err;
  if (x_dtype == X_F32) err = launch_kind<float>(kind, g, out1, out2, s);
  else if (x_dtype == X_BF16) err = launch_kind<__nv_bfloat16>(kind, g, out1, out2, s);
  else return (int)cudaErrorInvalidValue;
  if (err != 0 || splits == 1) return err;
  const long long blocks = std::min<long long>((2 * count + NT - 1) / NT, 4096);
  sum_splits<<<(int)blocks, NT, 0, s>>>(static_cast<const float*>(scratch),
                                         static_cast<float*>(o1), static_cast<float*>(o2),
                                         splits, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
