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
//       problems in one launch, client c reading every operand at its
//       own slab of a contiguous (clients, ...) stack.
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
// takes 2·B FLOPs for dW, 4·r for the two rank-r composes and 4·r for
// the two contractions; every input is read once in principle, and
// the (P x Q) dW, W and G never reach device memory.
// The design (the TPU kernel carried dW and the (bm, r) sums across
// sequential grid steps; Hopper has no sequential grid):
//   * a block owns 32 output rows and walks the other axis in tiles of
//     32 inside the block; per tile it sums the dW tile over the batch
//     (32-row steps through shared memory, fp32 accumulation), composes
//     the W1/W2 tiles with the forward kernel's compose (tiles.cuh),
//     forms G1/G2 in registers, and adds G·H into fp32 accumulators;
//   * the accumulators (2 x 32 rows x up to 256 rank columns) live in
//     registers, 2·NC·4 a thread; ranks above 256 take more blocks
//     (grid z), each owning 256 output columns;
//   * where the output rows give too few blocks for the card (side y
//     of a 1024-wide projection: 32 blocks), the sweep is split over
//     grid y and a second kernel sums the partial accumulators in a
//     fixed order: no atomics, so the result is deterministic;
//   * every ragged edge (batch, P, Q, r) is masked in the kernel;
//   * with a client axis, grid z carries client x rank-chunk group
//     (z = c * nz + group), the split sweep's scratch gains a client
//     dimension (2 x splits x clients x P x r), and the split count is
//     chosen after counting all clients' blocks, so C small problems
//     fill the card together before any sweep is split. Each client's
//     sums stay in its own registers and its own scratch rows: no
//     client's order depends on another's. The per-client offsets are
//     a compile-time option (CLIENTS): they hold six more pointers in
//     registers through the sweep, which the largest rank variants
//     cannot afford, so the 2-D form compiles without them.
// Not yet done (later work): tensor cores for the dW sum and the
// contractions, a pipelined load of the activation tiles.
#include <algorithm>

#include "tiles.cuh"

using namespace tiles;

namespace {

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };

using S = Wide;                 // compose shape: 32 own rows x 32 columns
constexpr int BP = S::BK;       // own rows per block
constexpr int BQ = BN;          // other-axis columns per sweep step
constexpr int BB = 32;          // batch rows per dW step
constexpr int CJ = S::CJ;       // tile entries per thread (4)
constexpr int NCMAX = 8;        // rank chunks of RC held per block
constexpr int WANT_BLOCKS_PER_SM = 2;
static_assert(BP == 32 && BQ == 32 && CJ == 4, "tile mapping below");

// Shared memory of one block (42 KB: static, below the 48 KB default).
struct __align__(16) Smem {
  FactorChunk<S> ch[2];         // rank chunks of the compose (tiles.cuh)
  float a[BB][BP];              // A tile, columns permuted (see stage)
  float d[BB][BQ + 1];          // D tile
  float g[2][BP][BQ + 1];       // G1, G2 tiles
  float h[2][BQ][RC];           // one rank chunk of H1, H2
};

// Column p of the A tile is stored at (p % 8) * 4 + p / 8, so the four
// entries a thread owns (rows kr, kr+8, kr+16, kr+24) are one float4.
__device__ __forceinline__ int perm(int p) { return (p % 8) * 4 + p / 8; }

template <typename XT, int KIND, int NC, bool CLIENTS>
__global__ void __launch_bounds__(NT)
dfactors_kernel(const XT* __restrict__ A, const XT* __restrict__ D,
                const float* __restrict__ F1, const float* __restrict__ F2,
                const float* __restrict__ H1, const float* __restrict__ H2,
                float* __restrict__ O1, float* __restrict__ O2, int B, int P,
                int Q, int r, int tiles_per_split, int clients, int nz) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BP;
  size_t client = 0;                      // this block's client
  int group = blockIdx.z;                 // its rank-chunk group
  if constexpr (CLIENTS) {
    client = blockIdx.z / nz;
    group = blockIdx.z % nz;
    A += client * B * P;
    D += client * B * Q;
    F1 += client * P * r;
    F2 += client * P * r;
    H1 += client * Q * r;
    H2 += client * Q * r;
  }
  const int c0 = group * NC * RC;         // the block's first rank column
  const int nq = (Q + BQ - 1) / BQ;
  const int t_lo = blockIdx.y * tiles_per_split;
  const int t_hi = min(nq, t_lo + tiles_per_split);
  const int nch = min(NC, (r - c0 + RC - 1) / RC);
  // tile entries of this thread: own rows kr + 8j, other column c (the
  // mapping of tiles::compose)
  const int c = tid % BN, kr = tid / BN;
  // contraction: own row pr, rank columns cq*4 .. cq*4+3 of each chunk
  const int pr = tid / 8, cq = tid % 8;
  const float* const Fs[2] = {F1, F2};
  const float* const Hs[2] = {H1, H2};

  float acc[2][NC][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[f][k][0] = acc[f][k][1] = acc[f][k][2] = acc[f][k][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int q0 = t * BQ;

    // ---- 1. the dW tile: Σ_b A[b, p] · D[b, q], fp32
    float dw[CJ] = {0.f, 0.f, 0.f, 0.f};
    for (int b0 = 0; b0 < B; b0 += BB) {
      float av[BB * BP / NT], dv[BB * BQ / NT];
#pragma unroll
      for (int e = 0; e < BB * BP / NT; ++e) {
        const int idx = tid + e * NT, row = idx / BP, col = idx % BP;
        const int b = b0 + row;
        av[e] = (b < B && p0 + col < P) ? to_f(A[(size_t)b * P + p0 + col]) : 0.f;
        dv[e] = (b < B && q0 + col < Q) ? to_f(D[(size_t)b * Q + q0 + col]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < BB * BP / NT; ++e) {
        const int idx = tid + e * NT, row = idx / BP, col = idx % BP;
        sm.a[row][perm(col)] = av[e];
        sm.d[row][col] = dv[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int bb = 0; bb < BB; ++bb) {
        const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[bb][kr * 4]);
        const float dq = sm.d[bb][c];
        dw[0] += a4.x * dq;
        dw[1] += a4.y * dq;
        dw[2] += a4.z * dq;
        dw[3] += a4.w * dq;
      }
      __syncthreads();
    }

    // ---- 2. the pre-activation W1, W2 tiles (syncs inside)
    float w[2][CJ];
    compose<S, 2>(Fs, Hs, P, Q, r, p0, q0, sm.ch, w);

    // ---- 3. G1, G2 (fedpara_grad.py:_tile_factor_grads)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int p = kr + j * (NT / BN);
      const float w1 = w[0][j], w2 = w[1][j];
      float g1, g2;
      if (KIND == K_TANH) {
        const float t1 = tanhf(w1), t2 = tanhf(w2);
        g1 = dw[j] * t2 * (1.f - t1 * t1);
        g2 = dw[j] * t1 * (1.f - t2 * t2);
      } else {
        g1 = dw[j] * (KIND == K_PFEDPARA ? w2 + 1.f : w2);
        g2 = dw[j] * w1;
      }
      const bool in = (p0 + p < P) && (q0 + c < Q);
      sm.g[0][p][c] = in ? g1 : 0.f;
      sm.g[1][p][c] = in ? g2 : 0.f;
    }

    // ---- 4. acc += G · H[q0:q0+32, rank chunk], chunk by chunk
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (k < nch) {
        const int cb = c0 + k * RC;
        float hv[2][BQ * RC / NT];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < BQ * RC / NT; ++e) {
            const int idx = tid + e * NT, q = idx / RC, cc = idx % RC;
            hv[f][e] = (q0 + q < Q && cb + cc < r)
                           ? __ldg(Hs[f] + (size_t)(q0 + q) * r + cb + cc) : 0.f;
          }
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < BQ * RC / NT; ++e) {
            const int idx = tid + e * NT;
            sm.h[f][idx / RC][idx % RC] = hv[f][e];
          }
        __syncthreads();   // also publishes step 3's G tiles
#pragma unroll 8
        for (int q = 0; q < BQ; ++q) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float g = sm.g[f][pr][q];
            const float4 h = *reinterpret_cast<const float4*>(&sm.h[f][q][cq * 4]);
            acc[f][k][0] += g * h.x;
            acc[f][k][1] += g * h.y;
            acc[f][k][2] += g * h.z;
            acc[f][k][3] += g * h.w;
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- write this block's sums (split y's partials when the sweep is
  // split): output layout (splits, clients, P, r)
  float* const Os[2] = {O1, O2};
  const size_t base = CLIENTS ? ((size_t)blockIdx.y * clients + client) * P * r
                              : (size_t)blockIdx.y * P * r;
  const int p = p0 + pr;
  if (p >= P) return;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= nch) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + k * RC + cq * 4 + e;
      if (col < r) {
        Os[0][base + (size_t)p * r + col] = acc[0][k][e];
        Os[1][base + (size_t)p * r + col] = acc[1][k][e];
      }
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
    for (int k = 0; k < splits; ++k) s += part[(f * splits + k) * count + j];
    (f == 0 ? o1 : o2)[j] = s;
  }
}

int rank_chunks(int r) {  // NC for rank r: chunks of 32, at most NCMAX
  const int need = (r + RC - 1) / RC;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : NCMAX;
}

struct Args {
  const void *a, *d, *f1, *f2, *h1, *h2;
  int clients, batch, P, Q, r, splits;
};

template <typename XT, int KIND, int NC>
int launch(const Args& g, float* o1, float* o2, cudaStream_t s) {
  const int nq = (g.Q + BQ - 1) / BQ;
  const int tps = (nq + g.splits - 1) / g.splits;
  const int nz = (g.r + NC * RC - 1) / (NC * RC);
  if ((long long)g.clients * nz > 65535) return (int)cudaErrorInvalidValue;   // grid z
  const dim3 grid((g.P + BP - 1) / BP, g.splits, g.clients * nz);
  auto k = g.clients > 1 ? dfactors_kernel<XT, KIND, NC, true>
                         : dfactors_kernel<XT, KIND, NC, false>;
  k<<<grid, NT, 0, s>>>(static_cast<const XT*>(g.a), static_cast<const XT*>(g.d),
                        static_cast<const float*>(g.f1), static_cast<const float*>(g.f2),
                        static_cast<const float*>(g.h1), static_cast<const float*>(g.h2), o1,
                        o2, g.batch, g.P, g.Q, g.r, tps, g.clients, nz);
  return (int)cudaGetLastError();
}

template <typename XT, int KIND>
int launch_nc(const Args& g, float* o1, float* o2, cudaStream_t s) {
  switch (rank_chunks(g.r)) {
    case 1: return launch<XT, KIND, 1>(g, o1, o2, s);
    case 2: return launch<XT, KIND, 2>(g, o1, o2, s);
    case 4: return launch<XT, KIND, 4>(g, o1, o2, s);
    default: return launch<XT, KIND, NCMAX>(g, o1, o2, s);
  }
}

template <typename XT>
int launch_kind(int kind, const Args& g, float* o1, float* o2, cudaStream_t s) {
  switch (kind) {
    case K_FEDPARA: return launch_nc<XT, K_FEDPARA>(g, o1, o2, s);
    case K_TANH: return launch_nc<XT, K_TANH>(g, o1, o2, s);
    case K_PFEDPARA: return launch_nc<XT, K_PFEDPARA>(g, o1, o2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// How many blocks share one output slab's sweep for `clients` (own P,
// other Q, rank r) problems on a card with `sms` SMs: 1 when the output
// rows of all clients alone give WANT_BLOCKS_PER_SM blocks per SM, else
// enough splits of the sweep to reach it (at most one per 32-column
// tile). With more than one, repro_fedpara_dfactors needs
// 2 x splits x clients x P x r fp32 of scratch.
int repro_dfactors_splits(int clients, int P, int Q, int r, int sms) {
  if (clients <= 0 || P <= 0 || Q <= 0 || r <= 0) return 1;
  const int nc = rank_chunks(r);
  const long long blocks = (long long)clients * ((P + BP - 1) / BP) *
                           ((r + nc * RC - 1) / (nc * RC));
  const long long want = (long long)WANT_BLOCKS_PER_SM * sms;
  if (blocks >= want) return 1;
  const int nq = (Q + BQ - 1) / BQ;
  const int splits = (int)std::min<long long>(nq, (want + blocks - 1) / blocks);
  const int tps = (nq + splits - 1) / splits;
  return (nq + tps - 1) / tps;   // every split owns at least one tile
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
  if (splits < 1 || (splits > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
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
