// Fused FedPara matmul for sm_90a, on the tensor cores:
//   y[c] = x[c] · (f1(X1[c] Y1[c]ᵀ) ⊙ f2(X2[c] Y2[c]ᵀ))   for every client c
// for the three paper variants: fedpara (identity), fedpara_tanh
// (tanh ⊙ tanh) and pfedpara (the "+1 switch" on f2); fp32 or bf16
// activations, fp32 factors.
//
// Replaces (TPU, Pallas):
//   K1  src/repro/kernels/fedpara_matmul.py:45 _kernel          -> repro_fedpara_matmul
//   K2  src/repro/kernels/fedpara_matmul.py:76 _kernel_batched  -> repro_fedpara_matmul
//   K3  src/repro/kernels/fedpara_grad.py:80 _dx_body           -> repro_fedpara_dx
//       (this kernel on the transposed weight), its 2-D form and its
//       lead=True form with a client axis
// K2 and K3 with a client axis put the client on grid z; K1 is the
// one-client case.
//
// What bounds it on an H100: the compose. Each weight costs two rank-r
// products, 4r operations (r = 160, 70, 211 at qwen3-8b's widths),
// against 2 per activation row for the contraction, and the reference
// composes in fp32. The cheapest route at fp32 accuracy is "3xTF32" on
// the tensor cores (495/3 TFLOP/s): each fp32 operand v is split into
// hi = tf32(v) and lo = v - hi, and each product is taken as
// hi·hi + hi·lo + lo·hi with fp32 accumulators, within about 1e-6 of an
// fp32 product (a single TF32 pass is 2-4e-4; kernels/ref.py holds both
// on the host). A 512-row prefill of one qwen3-8b layer does 1.513e11
// compose operations and 1.98e11 bf16 contraction operations: 1.117 ms
// at those two rates, the compose 0.917 of it.
//
// What the design does about it: the generic fused kernel of
// fused.cuh (its note gives the design: 3xTF32 compose warps and bf16 /
// 3xTF32 contraction warps apart, the X ring through mbarriers, m split
// across blocks for small launches, summed in a fixed order). Here it
// composes both factor pairs per tile (FedparaOp, NF = 2), and f1, f2
// and the Hadamard product are applied to the compose's accumulators in
// registers; the tile is rounded to bf16 as the reference casts it
// (fedpara_matmul.py:63-68), or split into TF32 halves for fp32
// activations.
// mma.sync with cp.async is the first step; wgmma with TMA is the
// target (TMA cannot load X at an odd r: its rows are not 16-byte
// aligned). What holds this version back (PERF.md section 6): the
// compose runs well below the mma.sync TF32 rate, bound by latency at 8
// compose warps per SM, and X is copied in 4-byte pieces at odd r.
//
// Registers, shared memory (r = 211) and spills, nvcc -Xptxas -v for
// sm_90a, 512 threads a block: bf16 x 512 rows 128 registers,
// 199,728 B; bf16 x 128 rows 98, 144,432 B; fp32 x 128 rows 118,
// 190,512 B; the split-sum kernel 32, none; no spills, no stack frame.
#include "fused.cuh"

namespace {

enum { K_FEDPARA = 0, K_TANH = 1, K_PFEDPARA = 2 };

__device__ __forceinline__ float variant(int kind, float a, float b) {
  if (kind == K_TANH) {
    a = tanhf(a);
    b = tanhf(b);
  } else if (kind == K_PFEDPARA) {
    b += 1.f;
  }
  return a * b;
}

// W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ), every client's factors at its own slab
// of a contiguous (clients, ·, r) stack.
struct FedparaOp {
  static constexpr int NF = 2;
  static constexpr bool kCache = false;
  using CT = float;
  const float *x1, *y1, *x2, *y2;
  int kind;
  const float* cache = nullptr;
  const float* scale = nullptr;
  __device__ __forceinline__ void factors(size_t c, int m, int n, int r,
                                          const float* (&X)[2], const float* (&Y)[2]) const {
    X[0] = x1 + c * m * (size_t)r;
    X[1] = x2 + c * m * (size_t)r;
    Y[0] = y1 + c * n * (size_t)r;
    Y[1] = y2 + c * n * (size_t)r;
  }
  __device__ __forceinline__ float weight(const float (&p)[2], float) const {
    return variant(kind, p[0], p[1]);
  }
};

}  // namespace

extern "C" {

// How many blocks split the m axis of a launch (>= 1): the fewest that
// fill the card's `sms` multiprocessors (fused.cuh splits_for). m is
// the contraction length (n for repro_fedpara_dx) and n the output
// width.
int repro_fedpara_splits(int clients, int rows, int m, int n, int r, int x_dtype, int sms) {
  return fused::splits_for<FedparaOp>(clients, rows, m, n, r, x_dtype, sms);
}

// K1 and K2: for each client c < clients, y[c] (rows, n) = x[c] (rows,
// m) · (f1(X1[c] Y1[c]ᵀ) ⊙ f2(X2[c] Y2[c]ᵀ)); x (clients, rows, m), X1,
// X2 (clients, m, r) and Y1, Y2 (clients, n, r) fp32, all contiguous;
// clients = 1 is K1's 2-D call. kind: 0 fedpara | 1 fedpara_tanh |
// 2 pfedpara. x_dtype: X_F32 | X_BF16 (y has x's dtype). splits: from
// repro_fedpara_splits; when > 1, ws is an fp32 workspace of splits x
// clients x rows x n. Returns the launch's cudaError_t (0 on success).
int repro_fedpara_matmul(const void* x, const void* x1, const void* y1, const void* x2,
                         const void* y2, void* y, void* ws, int clients, int rows, int m, int n,
                         int r, int kind, int x_dtype, int splits, void* stream) {
  if (kind < K_FEDPARA || kind > K_PFEDPARA) return (int)cudaErrorInvalidValue;
  const FedparaOp op{static_cast<const float*>(x1), static_cast<const float*>(y1),
                     static_cast<const float*>(x2), static_cast<const float*>(y2), kind};
  return fused::launch(op, x, y, ws, clients, rows, m, n, r, x_dtype, splits,
                       static_cast<cudaStream_t>(stream));
}

// K3, the input gradient of the fused matmul (replaces
// src/repro/kernels/fedpara_grad.py:_dx_body, both its forms):
//   dx[c] (rows, m) = dy[c] (rows, n) · W[c]ᵀ,  Wᵀ = f1(Y1 X1ᵀ) ⊙ f2(Y2 X2ᵀ),
// because f1 and f2 act elementwise and so commute with the transpose.
// dy takes x's place and (Y1, X1, Y2, X2) take (X1, Y1, X2, Y2)'s: the
// kernel above composes each Wᵀ tile on chip, casts it to dy's dtype
// (as _dx_body casts its tile) and contracts it; W is never stored.
// clients = 1 is the 2-D form, more is the lead=True form with dy
// (clients, rows, n). dx has dy's dtype; splits and ws as above, from
// repro_fedpara_splits(clients, rows, n, m, ...). Returns the launch's
// cudaError_t.
int repro_fedpara_dx(const void* dy, const void* x1, const void* y1, const void* x2,
                     const void* y2, void* dx, void* ws, int clients, int rows, int m, int n,
                     int r, int kind, int x_dtype, int splits, void* stream) {
  return repro_fedpara_matmul(dy, y1, x1, y2, x2, dx, ws, clients, rows, n, m, r, kind,
                              x_dtype, splits, stream);
}

}  // extern "C"
