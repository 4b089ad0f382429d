// masked_matmul and its gradients, for Hopper (sm_90a):
//   forward  out = x @ (w * m)
//   dX       dx  = dy @ (w * m)^T          (w and m read transposed, no copy)
//   dW       dw  = (x^T @ dy) * m          (mask in the epilogue: pruned slots
//                                           are exactly 0)
//   dM       dm  = (x^T @ dy) * w          (w in the epilogue; the gradient of
//                                           a mask that is tuned, as mask
//                                           tuning's straight-through scores
//                                           take it; pruned slots not zeroed)
//
// Replaces the Pallas TPU kernel `masked_matmul` in
// src/repro/kernels/masked_matmul/masked_matmul.py (body `_kernel`): the
// contraction of every masked linear of a sparse block. The JAX package has
// no backward kernel: its gradient is XLA's autodiff of apply_masks + einsum
// (src/repro/core/reconstruction.py::block_loss), the function dX and dW
// compute here, and dM is XLA's autodiff of the same product with respect
// to the mask (src/repro/core/mask_tuning.py::_masked_block).
//
// What bounds it on an H100: at the slice's shapes (M = 16384 rows against
// 4096x4096, 4096x11008 and 11008x4096 weights) each of the four products
// does about 2*M operations per weight byte, far above the ~295 operations
// per byte where bf16 tensor cores stop waiting on HBM, so all three are
// bound by operations: the tensor cores have to be kept fed, and each
// operand tile has to be reused from L2 by the blocks that run together.
//
// One generic tile GEMM C = A @ B serves the four products, templated on
// how A and B are laid out and where the mask goes, so they share one tile
// loop. One thread block owns one output tile and loops over the reduction
// inside the block (the TPU kernel's sequential K grid axis and its f32
// VMEM accumulator become that loop and registers). Every operand has a
// row stride (a (d, H, hd) leaf is read as (d, H*hd) without a copy) and
// ragged edges are handled (11008 = 86*128; 777-row cases).
//   * f32: a register-blocked SIMT GEMM with IEEE fp32 FMAs; no TF32, so it
//     holds the reference's 2e-5 tolerance.
//   * bf16: the wgmma main loop of gemm.cuh (a 256 x 128 output tile,
//     64-deep reduction steps, f32 accumulators, a TMA ring of 4 stages
//     filled by a lone warp, four consumer warpgroups), which nm_spmm.cu
//     shares. x and dy come in the 128-byte swizzle that wgmma reads,
//     K-major as A of the forward and dX, MN-major as dW's x^T and dy; w
//     MN-major in the forward, K-major in dX; and the uint8 mask tile,
//     unswizzled, beside w in the same stage. TMA writes shared memory as it
//     is, so w * m is formed there (gemm::MaskedB): in the forward and dX
//     the consumers multiply the w tile by the mask tile in place, two
//     16-byte chunks each, while the previous stage's products run. Nothing
//     weight-sized is written to HBM. Two other placements of that multiply
//     were measured and dropped (PERF.md): a producer warpgroup that
//     loaded w and m with plain loads and stored w * m into the stage was
//     bound by their latency, and a producer warpgroup that multiplied the
//     TMA-loaded tile in place, on a 128-row tile, was slower still. dW
//     reads dy as it is (gemm::PlainB) and selects 0 where the mask is 0 in
//     the epilogue; dM runs the same main loop and multiplies each f32
//     output pair by the pair of w beside it before its one rounding to
//     bf16 (gm::EPI_SCALE). The tensor maps are encoded on the host in each entry
//     point (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, see
//     hopper.cuh). It takes what the TMA takes: 16-byte-aligned operands
//     and masks, row strides that are multiples of 16 bytes (8 bf16 values,
//     16 mask bytes), and reduction and output widths that are multiples of
//     8, as in every linear of the model; it refuses others with
//     cudaErrorInvalidValue. Each output is a sum in a fixed order: a
//     repeated launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm.cuh"

namespace {

// ---------------------------------------------------------------- f32 ---
// C (Mc x Nc) = sum_r A(i, r) B(r, j), r < Kc.
//   A(i, r) = A[i*lda + r], or A[r*lda + i] with A_T;
//   B(r, j) = B[r*ldb + j], or B[j*ldb + r] with B_T;
//   B_MASK multiplies bm (B's layout, row stride ldbm) into B;
//   EPI (gemm.cuh's epilogues) writes C as it is, zeroes it wherever the
//   uint8 ce[i*ldce + j] is 0 (EPI_MASK), or multiplies it by the f32
//   ce[i*ldce + j] (EPI_SCALE).
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_T = 8, F_THREADS = 256;

template <bool A_T, bool B_T, bool B_MASK, int EPI>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
         const uint8_t* __restrict__ bm, const void* __restrict__ ce,
         float* __restrict__ C, int Mc, int Kc, int Nc, long long lda, long long ldb,
         long long ldbm, long long ldce, long long ldc) {
  __shared__ float As[F_BK][F_BM + 4];  // As[k][row]
  __shared__ float Bs[F_BK][F_BN + 4];  // Bs[k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * F_BM, col0 = blockIdx.x * F_BN;

  float acc[F_T][F_T];
#pragma unroll
  for (int i = 0; i < F_T; ++i)
#pragma unroll
    for (int j = 0; j < F_T; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kc; k0 += F_BK) {
    // neighbouring threads take neighbouring addresses in either layout
#pragma unroll
    for (int i = 0; i < (F_BM * F_BK) / F_THREADS; ++i) {
      const int e = tid + F_THREADS * i;
      const int r = A_T ? e % F_BM : e / F_BK, kk = A_T ? e / F_BM : e % F_BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < Mc && gk < Kc) ? A[A_T ? gk * lda + gr : gr * lda + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (F_BN * F_BK) / F_THREADS; ++i) {
      const int e = tid + F_THREADS * i;
      const int c = B_T ? e / F_BK : e % F_BN, kk = B_T ? e % F_BK : e / F_BN;
      const int gk = k0 + kk, gc = col0 + c;
      float v = 0.f;
      if (gk < Kc && gc < Nc) {
        v = B[B_T ? gc * ldb + gk : gk * ldb + gc];
        if (B_MASK) v *= static_cast<float>(bm[B_T ? gc * ldbm + gk : gk * ldbm + gc]);
      }
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[F_T], b[F_T];
#pragma unroll
      for (int i = 0; i < F_T; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < F_T; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < F_T; ++i)
#pragma unroll
        for (int j = 0; j < F_T; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < F_T; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= Mc) continue;
#pragma unroll
    for (int j = 0; j < F_T; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= Nc) continue;
      float val = acc[i][j];
      if (EPI == gm::EPI_MASK && static_cast<const uint8_t*>(ce)[gr * ldce + gc] == 0) val = 0.f;
      if (EPI == gm::EPI_SCALE) val *= static_cast<const float*>(ce)[gr * ldce + gc];
      C[gr * ldc + gc] = val;
    }
  }
}

// what the TMA takes: 16-byte-aligned operands and masks, every row stride
// a multiple of 16 bytes (8 bf16 values, 16 mask bytes); and contiguous
// widths that are multiples of 8, so an output pair is wholly in or out
bool bf16_ok(int Kc, int Nc, long long lda, long long ldb, long long ldbm, const void* A,
             const void* B, const void* bm) {
  return Kc % 8 == 0 && Nc % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 && ldbm % 16 == 0 &&
         hp::aligned(A, 16) && hp::aligned(B, 16) && hp::aligned(bm, 16);
}

template <bool A_T, bool B_T, bool B_MASK, int EPI>
int launch_f32(const void* A, const void* B, const void* bm, const void* ce, void* C, int Mc,
               int Kc, int Nc, long long lda, long long ldb, long long ldbm, long long ldce,
               long long ldc, void* stream) {
  dim3 grid((Nc + F_BN - 1) / F_BN, (Mc + F_BM - 1) / F_BM);
  gemm_f32<A_T, B_T, B_MASK, EPI><<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const uint8_t*>(bm), ce, static_cast<float*>(C), Mc, Kc, Nc, lda, ldb, ldbm,
      ldce, ldc);
  return static_cast<int>(cudaGetLastError());
}

// A_T / B_T as in gemm_f32: A_T reads A MN-major, B_T reads B K-major.
// Every operand by TMA (gemm.cuh): B = w, MN-major (64 x 64 boxes) or
// K-major (128-row boxes), with the mask in w's layout, one box a stage
// (64 x 128 or 128 x 64 bytes); or, for dW and dM, B = dy MN-major as it is.
template <bool A_T, bool B_T, bool B_MASK, int EPI>
int launch_bf16(const void* A, const void* B, const void* bm, const void* ce, void* C, int Mc,
                int Kc, int Nc, long long lda, long long ldb, long long ldbm, long long ldce,
                long long ldc, void* stream) {
  CUtensorMap map_a{};
  if (!gm::map_a(&map_a, A, Mc, Kc, lda, A_T)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (B_MASK) {
    typename gm::MaskedB<!B_T>::Maps maps{};
    const bool ok = B_T ? gm::map2(&maps.w, B, Nc, Kc, ldb, 64, 128) &&
                              gm::map2(&maps.m, bm, Nc, Kc, ldbm, 64, 128, true)
                        : gm::map2(&maps.w, B, Kc, Nc, ldb, 64, 64) &&
                              gm::map2(&maps.m, bm, Kc, Nc, ldbm, 128, 64, true);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return gm::launch<A_T, gm::MaskedB<!B_T>, EPI>(map_a, maps, ce, C, Mc, Kc, Nc, ldce, ldc,
                                                    stream);
  } else {
    static_assert(!B_T, "an unmasked B is read MN-major");
    gm::PlainB::Maps maps{};
    if (!gm::map2(&maps.b, B, Kc, Nc, ldb, 64, 64)) return static_cast<int>(cudaErrorInvalidValue);
    return gm::launch<A_T, gm::PlainB, EPI>(map_a, maps, ce, C, Mc, Kc, Nc, ldce, ldc, stream);
  }
}

}  // namespace

// Each entry point takes the matrices of its own product by their row
// strides; the mask m has w's shape (K, N).
//   forward: x (M, K), w (K, N)  -> out (M, N)
//   dX:      dy (M, N), w (K, N) -> dx (M, K)
//   dW:      x (M, K), dy (M, N) -> dw (K, N)     (m in the epilogue)
//   dM:      x (M, K), dy (M, N) -> dm (K, N)     (w in the epilogue)
extern "C" int masked_matmul_f32(const void* x, const void* w, const void* m, void* out,
                                 int M, int K, int N, long long ldx, long long ldw,
                                 long long ldm, long long ldo, void* stream) {
  return launch_f32<false, false, true, gm::EPI_NONE>(x, w, m, nullptr, out, M, K, N, ldx, ldw, ldm,
                                                      0, ldo, stream);
}

extern "C" int masked_matmul_bf16(const void* x, const void* w, const void* m, void* out,
                                  int M, int K, int N, long long ldx, long long ldw,
                                  long long ldm, long long ldo, void* stream) {
  if (!bf16_ok(K, N, ldx, ldw, ldm, x, w, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false, false, true, gm::EPI_NONE>(x, w, m, nullptr, out, M, K, N, ldx, ldw,
                                                       ldm, 0, ldo, stream);
}

extern "C" int masked_matmul_dx_f32(const void* dy, const void* w, const void* m, void* dx,
                                    int M, int K, int N, long long lddy, long long ldw,
                                    long long ldm, long long lddx, void* stream) {
  return launch_f32<false, true, true, gm::EPI_NONE>(dy, w, m, nullptr, dx, M, N, K, lddy, ldw, ldm,
                                                     0, lddx, stream);
}

extern "C" int masked_matmul_dx_bf16(const void* dy, const void* w, const void* m, void* dx,
                                     int M, int K, int N, long long lddy, long long ldw,
                                     long long ldm, long long lddx, void* stream) {
  if (!bf16_ok(N, K, lddy, ldw, ldm, dy, w, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false, true, true, gm::EPI_NONE>(dy, w, m, nullptr, dx, M, N, K, lddy, ldw,
                                                      ldm, 0, lddx, stream);
}

extern "C" int masked_matmul_dw_f32(const void* x, const void* dy, const void* m, void* dw,
                                    int M, int K, int N, long long ldx, long long lddy,
                                    long long ldm, long long lddw, void* stream) {
  return launch_f32<true, false, false, gm::EPI_MASK>(x, dy, nullptr, m, dw, K, M, N, ldx, lddy, 0,
                                                      ldm, lddw, stream);
}

extern "C" int masked_matmul_dw_bf16(const void* x, const void* dy, const void* m, void* dw,
                                     int M, int K, int N, long long ldx, long long lddy,
                                     long long ldm, long long lddw, void* stream) {
  // x is read along its rows (K wide) into the transposed A tile
  if (!(K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && lddy % 8 == 0 && hp::aligned(x, 16) &&
        hp::aligned(dy, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true, false, false, gm::EPI_MASK>(x, dy, nullptr, m, dw, K, M, N, ldx, lddy, 0,
                                                       ldm, lddw, stream);
}

extern "C" int masked_matmul_dm_f32(const void* x, const void* dy, const void* w, void* dm,
                                    int M, int K, int N, long long ldx, long long lddy,
                                    long long ldw, long long lddm, void* stream) {
  return launch_f32<true, false, false, gm::EPI_SCALE>(x, dy, nullptr, w, dm, K, M, N, ldx, lddy, 0,
                                                       ldw, lddm, stream);
}

extern "C" int masked_matmul_dm_bf16(const void* x, const void* dy, const void* w, void* dm,
                                     int M, int K, int N, long long ldx, long long lddy,
                                     long long ldw, long long lddm, void* stream) {
  // dW's TMA rules for x and dy; w is read as bf16 pairs in the epilogue
  if (!(K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && lddy % 8 == 0 && ldw % 8 == 0 &&
        hp::aligned(x, 16) && hp::aligned(dy, 16) && hp::aligned(w, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true, false, false, gm::EPI_SCALE>(x, dy, nullptr, w, dm, K, M, N, ldx, lddy,
                                                        0, ldw, lddm, stream);
}
