// Serve-path kernels for sm_90a: the int8/fp16 weight-cache matmul and
// the pFedPara cache + residual matmul (single- and many-user).
//
// Replaces (TPU, Pallas):
//   K8  src/repro/kernels/serve_matmul.py:48 _w8_kernel           -> repro_w8_matmul
//   K9  src/repro/kernels/serve_matmul.py:68 _resid_kernel        -> repro_cache_residual (U = 1)
//   K10 src/repro/kernels/serve_matmul.py:92 _resid_kernel_users  -> repro_cache_residual
//
// K8, y = (x · W) · s with W int8 (per-column scale s) or fp16.
//   * At decode (rows <= 32) it is bound by the cache's bytes: every
//     weight is read once and used for a few rows (a 4096 x 12288 int8
//     cache is 50 MB, 15 us at 3.35 TB/s). It runs on tiles.cuh's
//     CUDA-core driver (Skinny: 32 output columns, steps of 128 rows of
//     m with 16-byte loads, split over 8 warps), small blocks so that
//     many stay resident and keep loads in flight.
//   * At prefill (rows > 32) each weight feeds every row, and it is
//     bound by operations: 2·rows·m·n on the tensor cores (0.200 ms per
//     qwen3-8b layer at 512 rows and 989 TFLOP/s). w8_wide_kernel is a
//     tensor-core GEMM: a block of 8 warps owns 128 rows x 256 columns
//     (bf16; warp tiles 64 x 64) or 128 x 128 (fp32; 64 x 32) and walks
//     m in steps of 64 through a ring of 3-4 shared-memory stages
//     filled by 16-byte cp.async (masked plain loads where a row is not
//     16-byte aligned). The cache tile enters at its stored width and is
//     widened on chip only:
//       - bf16 activations: one pass per step widens the raw tile to a
//         bf16 [k][n] tile: int8 exactly, by integer and fp32-add
//         operations rather than conversion instructions (which run at
//         a fraction of the rate), into a tile of its own; fp16 rounded
//         to bf16, as the reference widens to x's dtype, in place in its
//         ring stage (both are 2 bytes). It is contracted with mma.sync
//         m16n8k16 (B through ldmatrix.trans, fragments double-buffered
//         in registers); the pass for step s + 1 is interleaved with
//         the MMAs of step s, in the same barrier interval. The
//         epilogue stores column pairs (bf16x2, or float2 partial sums);
//       - fp32 activations: every int8 value and every finite fp16 value
//         is exact in TF32, so two TF32 passes, x_hi·W + x_lo·W, give
//         fp32 accuracy; W is widened in registers as its fragments are
//         read, and each step's products are summed in fresh registers
//         and added on the CUDA cores (the tensor core's accumulator
//         truncates).
//     The per-column scale multiplies the fp32 accumulator once, at the
//     store (it commutes with the row sum, serve_matmul.py:18-23).
//     Launches too small to fill the card (n = 1024 at 512 rows: 16
//     blocks) split m across blocks into an fp32 workspace, summed in a
//     fixed order by fused.cuh's second pass: no atomics.
//     What holds it back (PERF.md section 6): mma.sync's steady state,
//     well below the dense rate, and a fixed cost per call (the first
//     cold stages, the epilogue, the split-sum pass). A second block per
//     SM (steps of 32, at most 128 registers) was no faster. Later
//     work: wgmma with the widened tile as B in shared memory (allowed
//     for 16-bit types) and TMA loads, for the full rate.
//
// K9/K10, y = x · ((W·s) ⊙ (X2ᵤ Y2ᵤᵀ + 1)) per user u, one shared cache.
//   Bound by operations: the residual costs 2·r operations per weight
//   and user at fp32 accuracy (3xTF32 on the tensor cores), against
//   2·t for the contraction. It is fused.cuh's kernel with ResidOp: one
//   rank product per tile (NF = 1) composed by the compose warps in
//   3xTF32, the cache entry entering exactly, the "+1" and the product
//   applied in registers and the tile rounded once (bf16) or split into
//   TF32 halves (fp32 x) for the contraction warps. The user is grid
//   axis z; x, X2, Y2 and y are read at the user's slab and the cache
//   without a user stride (each user's block re-reads it: at most 4 x
//   the cache's bytes at 4 users, a few per cent of the compose's time).
//   At decode widths (t <= 64 rows per user) a block holds 64 rows and
//   is compiled for two blocks per SM (64 registers a thread), so 16
//   compose warps share an SM and hide each other's latency: the
//   compose, not the contraction, is the work there. Small launches
//   split m (t = 1 at n = 1024). Later work: wgmma for the compose.
//
// Registers and spills, nvcc -Xptxas -v for sm_90a: K8 prefill bf16 217
// (fp16 cache) / 214 (int8), fp32 191 / 198; K8 decode 97-118; K9/K10
// bf16 88 (128 rows a block), 126 (512), 64 (64 rows, two blocks an SM),
// fp32 120 (128 rows) and 64 with 8 bytes spilled (64 rows); no other
// spills. Dynamic shared memory: repro_serve_smem_bytes.
#include "fused.cuh"

using tiles::X_BF16;
using tiles::X_F32;
using tiles::W_F16;
using tiles::W_I8;

namespace {

// ------------------------------------------------------------ K8, decode

template <typename XT, typename WT>
__global__ void __launch_bounds__(tiles::NT)
w8_skinny_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                 const float* __restrict__ scale, XT* __restrict__ y, int rows, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  tiles::tiled_matmul<XT, WT>(x, w, y, scale, rows, m, n, smem);
}

template <typename XT, typename WT>
int launch_w8_skinny(const void* x, const void* w, const void* scale, void* y, int rows,
                     int m, int n, cudaStream_t s) {
  auto k = w8_skinny_kernel<XT, WT>;
  cudaError_t err = tiles::allow_smem(k, tiles::smem_bytes(tiles::Skinny::MAXR));
  if (err != cudaSuccess) return (int)err;
  k<<<tiles::grid_for(rows, n), tiles::NT, tiles::smem_bytes(rows), s>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), static_cast<const float*>(scale),
      static_cast<XT*>(y), rows, m, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ K8, prefill

namespace w8 {

constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int BM = 128;       // activation rows per block
constexpr int BK = 64;        // rows of m per step
constexpr int XS = BK + 8;    // x stage row stride (elements)

// Output columns per block: 256 for bf16 (warp tiles of 64 x 64, half
// the shared-memory reads per MMA of 64 x 32), 128 for fp32 (64 x 32:
// its per-step partial sums double the accumulators).
template <typename XT> __host__ __device__ constexpr int bn() { return sizeof(XT) == 2 ? 256 : 128; }
// bf16 activations widen a cache tile one step ahead of its
// contraction: an int8 tile into a separate bf16 tile (double-buffered),
// an fp16 tile in place, in its own ring stage (both are 2 bytes a
// value). The ring keeps a stage more for bf16, so that two steps of
// loads stay in flight.
template <typename XT, typename WT> __host__ __device__ constexpr bool in_place() {
  return sizeof(XT) == 2 && sizeof(WT) == 2;
}
template <typename XT, typename WT> __host__ __device__ constexpr int stages() {
  return sizeof(XT) == 2 ? 4 : 3;
}
// raw cache stage row stride in bytes: 16 past the row, so the fp32
// path's column reads of 4 rows x 8 columns hit distinct banks
template <typename XT, typename WT> __host__ __device__ constexpr int raw_stride() {
  return bn<XT>() * (int)sizeof(WT) + 16;
}
template <typename XT, typename WT> __host__ __device__ constexpr int stage_bytes() {
  return BM * XS * (int)sizeof(XT) + BK * raw_stride<XT, WT>();
}
// the widened bf16 tile's row stride (elements)
template <typename XT> __host__ __device__ constexpr int wst() { return bn<XT>() + 8; }
template <typename XT, typename WT> constexpr size_t smem_bytes() {
  return (size_t)stages<XT, WT>() * stage_bytes<XT, WT>() +
         (sizeof(XT) == 2 && !in_place<XT, WT>() ? 2 * BK * wst<XT>() * sizeof(__nv_bfloat16)
                                                 : 0);
}

// Four int8 values (one word) as two bf16 pairs, exactly and without
// conversion instructions (which run at a quarter of the FMA rate or
// less): byte b, biased to u = b ^ 0x80, placed under the exponent of
// 2^23 is the fp32 value 2^23 + u; subtracting 2^23 + 128 leaves b, an
// integer of at most 8 significant bits, whose fp32 pattern's top half
// is its bf16 pattern.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) -
                           8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// Grid: (⌈n/BN⌉, row blocks x splits). Block (bx, by) computes
// y[row0 : row0+BM, n0 : n0+BN] over its split's steps of m: into y
// (scaled) when splits == 1, else into ws[split] (fp32, unscaled).
template <typename XT, typename WT>
__global__ void __launch_bounds__(NT, 1)
w8_wide_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale, XT* __restrict__ y, float* __restrict__ ws,
               int rows, int m, int n, int splits) {
  constexpr bool BF16 = sizeof(XT) == 2;
  constexpr int BN = bn<XT>(), NJ = BN / 32;   // columns per block; n8 tiles per warp
  constexpr int ST = stages<XT, WT>(), SB = stage_bytes<XT, WT>(), RS = raw_stride<XT, WT>();
  constexpr int WST = wst<XT>();
  constexpr int VX = 16 / sizeof(XT), VW = 16 / sizeof(WT);
  constexpr int WCH = BK * (BN / VW) / NT;     // raw 16-byte vectors per thread and step
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;   // warp tile: rows 64 wr.., columns BN/4 wc..
  const int n0 = blockIdx.x * BN;
  const int row_blocks = (rows + BM - 1) / BM;
  const int rb = blockIdx.y % row_blocks, split = blockIdx.y / row_blocks;
  const int row0 = rb * BM, nr = min(BM, rows - row0);
  const int steps = (m + BK - 1) / BK;
  const int s0 = (int)((long long)steps * split / splits);
  const int ns = (int)((long long)steps * (split + 1) / splits) - s0;
  x += (size_t)row0 * m;
  const bool xvec = m % VX == 0 && tiles::aligned16(x);
  const bool wvec = n % VW == 0 && tiles::aligned16(w);

  auto xstage = [&](int i) { return reinterpret_cast<XT*>(smem + (i % ST) * SB); };
  auto wstage = [&](int i) { return smem + (i % ST) * SB + BM * XS * sizeof(XT); };
  // the widened tile of step i: [BK][WST] bf16, in stage i (fp16) or in
  // wide[i % 2] after the ring (int8)
  constexpr bool INPLACE = in_place<XT, WT>();
  static_assert(!INPLACE || RS == WST * (int)sizeof(__nv_bfloat16), "in-place row stride");
  auto widened = [&](int i) {
    return INPLACE ? reinterpret_cast<__nv_bfloat16*>(wstage(i))
                   : reinterpret_cast<__nv_bfloat16*>(smem + ST * SB) + (i & 1) * BK * WST;
  };

  // step s0 + i of x (BM x BK) and of the cache (BK x BN) into stage i % ST
  auto load = [&](int i) {
    const int k0 = (s0 + i) * BK;
    XT* xd = xstage(i);
    for (int c = tid; c < BM * (BK / VX); c += NT) {
      const int row = c / (BK / VX), kk = (c % (BK / VX)) * VX;
      XT* dst = xd + row * XS + kk;
      const XT* src = x + (size_t)row * m + k0 + kk;
      if (xvec) {
        mma::cp_async16(dst, src, row < nr && k0 + kk < m);
      } else {
        for (int e = 0; e < VX; ++e)
          dst[e] = row < nr && k0 + kk + e < m ? src[e] : fused::zero_of<XT>();
      }
    }
    unsigned char* wd = wstage(i);
    for (int c = tid; c < BK * (BN / VW); c += NT) {
      const int kk = c / (BN / VW), j = (c % (BN / VW)) * VW;
      WT* dst = reinterpret_cast<WT*>(wd + kk * RS) + j;
      const WT* src = w + (size_t)(k0 + kk) * n + n0 + j;
      if (wvec) {
        mma::cp_async16(dst, src, k0 + kk < m && n0 + j < n);
      } else {
        for (int e = 0; e < VW; ++e)
          dst[e] = k0 + kk < m && n0 + j + e < n ? src[e] : fused::zero_of<WT>();
      }
    }
  };
  // bf16: part `part` of 4 of the raw cache tile of stage i, widened to
  // widened(i), 8 values (one 16-byte store) at a time: a quarter-warp
  // covers 128 contiguous bytes of a row, free of bank conflicts (in
  // place, each thread rewrites the 16 bytes it read)
  auto widen = [&](int i, int part) {
    constexpr int CPR = BN / 8, CH = BK * CPR / NT;   // chunks per row, per thread
    const unsigned char* raw = wstage(i);
    __nv_bfloat16* wd = widened(i);
#pragma unroll
    for (int p = 0; p < CH / 4; ++p) {
      const int c = tid + (part * (CH / 4) + p) * NT;
      const int kk = c / CPR, j = (c % CPR) * 8;
      const unsigned char* src = raw + kk * RS + j * sizeof(WT);
      uint4 q;
      if constexpr (sizeof(WT) == 1) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        const uint2 a = i8x4_to_bf16x4(v.x), b = i8x4_to_bf16x4(v.y);
        q = make_uint4(a.x, a.y, b.x, b.y);
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        uint32_t h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(tiles::elem<WT>(v, 2 * e),
                                                          tiles::elem<WT>(v, 2 * e + 1));
          h[e] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        q = make_uint4(h[0], h[1], h[2], h[3]);
      }
      *reinterpret_cast<uint4*>(wd + kk * WST + j) = q;
    }
  };

  float acc[4][NJ][4];                   // [m16 tile][n8 tile][C fragment]
  float pt[BF16 ? 1 : 4][NJ][4];         // fp32: one step's partial sums
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < NJ; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[a][b][e] = 0.f;
        if constexpr (!BF16) pt[a][b][e] = 0.f;
      }

  // the contraction of step i: acc += x tile · W tile; bf16 also widens
  // step i + 1 (when `next`), a quarter after each 16 rows of m, so that
  // its conversions fill the gaps between the MMAs
  auto contract = [&](int i, bool next) {
    const XT* xs = xstage(i);
    if constexpr (BF16) {
      const __nv_bfloat16* wt = widened(i);
      // the fragments of 16 rows of m, double-buffered: those of slice
      // u + 1 are read while slice u's MMAs run
      uint32_t a[2][4][4], b[2][NJ][2];
      auto frags = [&](int u) {
        const int kk = 16 * u, f = u & 1;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          mma::ldsm_x4(a[f][mi], xs + (wr * 64 + 16 * mi + (lane & 15)) * XS + kk + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t t[4];
          mma::ldsm_x4_trans(t, wt + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * WST +
                                    wc * (BN / 4) + 16 * np + 8 * (lane >> 4));
          b[f][2 * np][0] = t[0];
          b[f][2 * np][1] = t[1];
          b[f][2 * np + 1][0] = t[2];
          b[f][2 * np + 1][1] = t[3];
        }
      };
      frags(0);
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
        if (u + 1 < BK / 16) frags(u + 1);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) mma::mma_bf16(acc[mi][nj], a[u & 1][mi], b[u & 1][nj]);
        if (next) widen(i + 1, u);
      }
    } else {
      // x_lo·W + x_hi·W in TF32 (W exact), into pt; the MMA's k index c
      // maps to row 2c and c + 4 to row 2c + 1 of the step (mma.cuh)
      const WT* raw = reinterpret_cast<const WT*>(wstage(i));
      constexpr int RW = RS / sizeof(WT);
#pragma unroll 2
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[4][4], al[4][4], b[NJ][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int row = wr * 64 + 16 * mi + g;
          const float2 v0 = *reinterpret_cast<const float2*>(xs + row * XS + kk + 2 * c4);
          const float2 v1 = *reinterpret_cast<const float2*>(xs + (row + 8) * XS + kk + 2 * c4);
          mma::split(v0.x, ah[mi][0], al[mi][0]);
          mma::split(v1.x, ah[mi][1], al[mi][1]);
          mma::split(v0.y, ah[mi][2], al[mi][2]);
          mma::split(v1.y, ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const int col = wc * (BN / 4) + 8 * nj + g;
          b[nj][0] = __float_as_uint(tiles::to_f(raw[(kk + 2 * c4) * RW + col]));
          b[nj][1] = __float_as_uint(tiles::to_f(raw[(kk + 2 * c4 + 1) * RW + col]));
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) mma::mma_tf32(pt[mi][nj], al[mi], b[nj]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) mma::mma_tf32(pt[mi][nj], ah[mi], b[nj]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma::add_to(acc[mi][nj], pt[mi][nj]);
    }
  };

  // ---- the ring: step i lands in stage i % ST. Iteration i waits for
  // the step it reads (bf16: i + 1, which it widens; fp32: i), passes a
  // block barrier (after which every thread is done with iteration
  // i - 1, the last reader of the stage refilled next), issues the loads
  // of step i + ST - 1, then works.
  constexpr int AHEAD = BF16 ? 1 : 0;   // steps widened ahead of the contraction
  for (int i = 0; i < ST - 1; ++i) {
    if (i < ns) load(i);
    mma::cp_async_commit();
  }
  if constexpr (BF16) {
    mma::cp_async_wait<ST - 2>();
    __syncthreads();
    if (ns > 0)
      for (int part = 0; part < 4; ++part) widen(0, part);
  }
  for (int i = 0; i < ns; ++i) {
    mma::cp_async_wait<ST - 2 - AHEAD>();
    __syncthreads();
    if (i + ST - 1 < ns) load(i + ST - 1);
    mma::cp_async_commit();
    contract(i, BF16 && i + 1 < ns);
  }

  // ---- epilogue: acc[mi][nj][2h + e] is y[row 64wr+16mi+g+8h][col
  // (BN/4)wc+8nj+2c4+e]; the two columns of a pair go out in one store
  // where n is even
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * 64 + 16 * mi + g + 8 * h;
        const int col = n0 + wc * (BN / 4) + 8 * nj + 2 * c4;
        if (row >= nr || col >= n) continue;
        float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        const size_t at = (size_t)(row0 + row) * n + col;
        if (splits > 1) {
          float* o = ws + (size_t)split * rows * n + at;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (col + 1 < n) o[1] = v1;
          }
        } else {
          if (scale != nullptr) {
            v0 *= scale[col];
            if (col + 1 < n) v1 *= scale[col + 1];
          }
          if (pairs) {
            if constexpr (BF16)
              *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
          } else {
            y[at] = tiles::from_f<XT>(v0);
            if (col + 1 < n) y[at + 1] = tiles::from_f<XT>(v1);
          }
        }
      }
}

template <typename XT, typename WT>
cudaError_t prepare() {
  return tiles::allow_smem(w8_wide_kernel<XT, WT>, smem_bytes<XT, WT>());
}

template <typename XT, typename WT>
int splits(int rows, int m, int n, int sms) {
  int per_sm = 0;
  if (prepare<XT, WT>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w8_wide_kernel<XT, WT>, NT,
                                                    smem_bytes<XT, WT>()) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long blocks = (long long)((n + bn<XT>() - 1) / bn<XT>()) * ((rows + BM - 1) / BM);
  return fused::pick_splits(blocks, (m + BK - 1) / BK, (long long)sms * per_sm);
}

template <typename XT, typename WT>
int launch(const void* x, const void* w, const void* scale, void* y, void* ws, int rows, int m,
           int n, int splits, cudaStream_t s) {
  cudaError_t err = prepare<XT, WT>();
  if (err != cudaSuccess) return (int)err;
  const long long gy = (long long)((rows + BM - 1) / BM) * splits;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + bn<XT>() - 1) / bn<XT>(), (unsigned)gy);
  w8_wide_kernel<XT, WT><<<grid, NT, smem_bytes<XT, WT>(), s>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), static_cast<const float*>(scale),
      static_cast<XT*>(y), static_cast<float*>(ws), rows, m, n, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fused::sum_splits<XT>(static_cast<const float*>(ws), static_cast<XT*>(y),
                                    static_cast<const float*>(scale), (size_t)rows * n, n,
                                    splits, s);
}

}  // namespace w8

// Activation rows up to which K8 takes the decode kernel.
constexpr int W8_SKINNY_ROWS = tiles::Skinny::MAXR;

template <typename XT, typename WT>
int launch_w8(const void* x, const void* w, const void* scale, void* y, void* ws, int rows,
              int m, int n, int splits, cudaStream_t s) {
  if (rows <= W8_SKINNY_ROWS) return launch_w8_skinny<XT, WT>(x, w, scale, y, rows, m, n, s);
  return w8::launch<XT, WT>(x, w, scale, y, ws, rows, m, n, splits, s);
}

// ------------------------------------------------------------ K9/K10

// W = cache ⊙ (X2ᵤ Y2ᵤᵀ + 1), user u's factor slabs at x2 + u·x2_us and
// y2 + u·y2_us, one (m, n) cache for every user, scaled at the store.
template <typename WT>
struct ResidOp {
  static constexpr int NF = 1;
  static constexpr bool kCache = true;
  using CT = WT;
  const float *x2, *y2;
  long long x2_us, y2_us;
  const WT* cache;
  const float* scale;
  __device__ __forceinline__ void factors(size_t u, int, int, int, const float* (&X)[1],
                                          const float* (&Y)[1]) const {
    X[0] = x2 + u * x2_us;
    Y[0] = y2 + u * y2_us;
  }
  // the cache value enters exactly; the tile rounds once, at its store
  __device__ __forceinline__ float weight(const float (&p)[1], float w) const {
    return w * (p[0] + 1.f);
  }
};

}  // namespace

extern "C" {

// How many blocks split the m axis of a K8 launch (>= 1; 1 at decode
// width): the fewest that fill the card's `sms` multiprocessors.
int repro_w8_splits(int rows, int m, int n, int x_dtype, int w_dtype, int sms) {
  if (rows <= W8_SKINNY_ROWS || m <= 0 || n <= 0 || sms <= 0) return 1;
  if (x_dtype == X_F32 && w_dtype == W_I8) return w8::splits<float, int8_t>(rows, m, n, sms);
  if (x_dtype == X_F32 && w_dtype == W_F16) return w8::splits<float, __half>(rows, m, n, sms);
  if (x_dtype == X_BF16 && w_dtype == W_I8)
    return w8::splits<__nv_bfloat16, int8_t>(rows, m, n, sms);
  if (x_dtype == X_BF16 && w_dtype == W_F16)
    return w8::splits<__nv_bfloat16, __half>(rows, m, n, sms);
  return 1;
}

// K8: y (rows, n) = (x (rows, m) · W (m, n)) · scale (n); scale may be
// null. x_dtype: X_F32 | X_BF16 (y has x's dtype); w_dtype: W_I8 |
// W_F16. splits: from repro_w8_splits; when > 1, ws is an fp32
// workspace of splits x rows x n. Returns the cudaError_t of the launch
// (0 on success).
int repro_w8_matmul(const void* x, const void* w, const void* scale, void* y, void* ws,
                    int rows, int m, int n, int x_dtype, int w_dtype, int splits,
                    void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == X_F32 && w_dtype == W_I8)
    return launch_w8<float, int8_t>(x, w, scale, y, ws, rows, m, n, splits, s);
  if (x_dtype == X_F32 && w_dtype == W_F16)
    return launch_w8<float, __half>(x, w, scale, y, ws, rows, m, n, splits, s);
  if (x_dtype == X_BF16 && w_dtype == W_I8)
    return launch_w8<__nv_bfloat16, int8_t>(x, w, scale, y, ws, rows, m, n, splits, s);
  if (x_dtype == X_BF16 && w_dtype == W_F16)
    return launch_w8<__nv_bfloat16, __half>(x, w, scale, y, ws, rows, m, n, splits, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory in bytes of the block that `kernel` (0: K8,
// 1: K9/K10) launches at these shapes (ptxas reports static shared
// memory only); -1 for an unknown kernel or dtype.
int repro_serve_smem_bytes(int kernel, int rows, int r, int x_dtype, int w_dtype) {
  const bool f32 = x_dtype == X_F32, i8 = w_dtype == W_I8;
  if ((!f32 && x_dtype != X_BF16) || (!i8 && w_dtype != W_F16)) return -1;
  if (kernel == 0) {
    if (rows <= W8_SKINNY_ROWS) return (int)tiles::smem_bytes(rows);
    if (f32) return (int)(i8 ? w8::smem_bytes<float, int8_t>() : w8::smem_bytes<float, __half>());
    return (int)(i8 ? w8::smem_bytes<__nv_bfloat16, int8_t>()
                    : w8::smem_bytes<__nv_bfloat16, __half>());
  }
  if (kernel != 1) return -1;
  switch (fused::rows_per_block<1>(rows, r, x_dtype)) {
    case 64: return (int)(f32 ? fused::smem_bytes<1, float, 64>(r)
                              : fused::smem_bytes<1, __nv_bfloat16, 64>(r));
    case 512: return (int)fused::smem_bytes<1, __nv_bfloat16, 512>(r);
    default: return (int)(f32 ? fused::smem_bytes<1, float, 128>(r)
                              : fused::smem_bytes<1, __nv_bfloat16, 128>(r));
  }
}

// How many blocks split the m axis of a K9/K10 launch (>= 1).
int repro_cache_residual_splits(int users, int t, int m, int n, int r, int x_dtype, int w_dtype,
                                int sms) {
  if (w_dtype == W_F16)
    return fused::splits_for<ResidOp<__half>>(users, t, m, n, r, x_dtype, sms);
  return fused::splits_for<ResidOp<int8_t>>(users, t, m, n, r, x_dtype, sms);
}

// K9/K10: y (U, t, n) = x (U, t, m) · ((W·scale) ⊙ (X2ᵤ Y2ᵤᵀ + 1)) per
// user u, with fp32 factor slabs X2ᵤ (m, r) at x2 + u·x2_us and Y2ᵤ
// (n, r) at y2 + u·y2_us (each slab contiguous), and one shared cache W
// (m, n); scale may be null. splits: from repro_cache_residual_splits;
// when > 1, ws is an fp32 workspace of splits x U x t x n. Returns the
// cudaError_t of the launch.
int repro_cache_residual(const void* x, const void* w, const void* scale, const void* x2,
                         const void* y2, void* y, void* ws, int users, int t, int m, int n,
                         int r, long long x2_us, long long y2_us, int x_dtype, int w_dtype,
                         int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f2 = static_cast<const float*>(x2);
  const float* g2 = static_cast<const float*>(y2);
  const float* sc = static_cast<const float*>(scale);
  if (w_dtype == W_I8) {
    const ResidOp<int8_t> op{f2, g2, x2_us, y2_us, static_cast<const int8_t*>(w), sc};
    return fused::launch(op, x, y, ws, users, t, m, n, r, x_dtype, splits, s);
  }
  if (w_dtype == W_F16) {
    const ResidOp<__half> op{f2, g2, x2_us, y2_us, static_cast<const __half*>(w), sc};
    return fused::launch(op, x, y, ws, users, t, m, n, r, x_dtype, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
