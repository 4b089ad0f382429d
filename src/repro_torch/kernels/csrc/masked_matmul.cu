// masked_matmul and its gradients, for Hopper (sm_90a):
//   forward  out = x @ (w * m)
//   dX       dx  = dy @ (w * m)^T          (w and m read transposed, no copy)
//   dW       dw  = (x^T @ dy) * m          (mask in the epilogue: pruned slots
//                                           are exactly 0)
//
// Replaces the Pallas TPU kernel `masked_matmul` in
// src/repro/kernels/masked_matmul/masked_matmul.py (body `_kernel`): the
// contraction of every masked linear of a sparse block. The JAX package has
// no backward kernel: its gradient is XLA's autodiff of apply_masks + einsum
// (src/repro/core/reconstruction.py::block_loss), the function dX and dW
// compute here.
//
// What bounds it on an H100: at the slice's shapes (M = 16384 rows against
// 4096x4096, 4096x11008 and 11008x4096 weights) each of the three products
// does about 2*M operations per weight byte, far above the ~295 operations
// per byte where bf16 tensor cores stop waiting on HBM, so all three are
// bound by operations.
//
// Design: one generic tile GEMM C = A @ B, templated on whether A and B are
// read transposed and where the mask goes, so the three products share one
// tile loop. One thread block owns one output tile and loops over the
// reduction inside the block (the TPU kernel's sequential K grid axis and
// its f32 VMEM accumulator become that loop and registers). The forward
// and dX load the w tile and the uint8 mask tile together and form w*m in
// w's dtype on the way into shared memory, so nothing weight-sized is
// written back; dX reads both along w's rows, which are contiguous, and
// keeps the tile transposed in shared memory (WMMA col_major fragments).
// dW reduces over the 16384 rows inside the block, reads x along its rows
// into a transposed tile, and applies the mask and the cast to w's dtype in
// the epilogue. Every operand has a row stride (a (d, H, hd) leaf is read
// as (d, H*hd) without a copy) and the kernels mask ragged edges
// (11008 = 86*128).
//   * f32: a register-blocked SIMT GEMM with IEEE fp32 FMAs; no TF32, so it
//     holds the reference's 2e-5 tolerance.
//   * bf16: WMMA 16x16x16 tensor-core products with f32 accumulators, cast
//     to bf16 at the store, 16-byte vector loads with the next tile
//     prefetched into registers. It takes 16-byte-aligned operands only
//     (the reduction and output widths and the row strides multiples of 8,
//     as in every linear of the model) and refuses others with
//     cudaErrorInvalidValue.
// No TMA, wgmma or warp specialisation yet; that is later work.
#include "wmma_tile.cuh"

namespace {

// ---------------------------------------------------------------- f32 ---
// C (Mc x Nc) = sum_r A(i, r) B(r, j), r < Kc.
//   A(i, r) = A[i*lda + r], or A[r*lda + i] with A_T;
//   B(r, j) = B[r*ldb + j], or B[j*ldb + r] with B_T;
//   B_MASK multiplies bm (B's layout, row stride ldbm) into B;
//   C_MASK zeroes C wherever cm[i*ldcm + j] is 0.
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_T = 8, F_THREADS = 256;

template <bool A_T, bool B_T, bool B_MASK, bool C_MASK>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
         const uint8_t* __restrict__ bm, const uint8_t* __restrict__ cm,
         float* __restrict__ C, int Mc, int Kc, int Nc, long long lda, long long ldb,
         long long ldbm, long long ldcm, long long ldc) {
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
      if (C_MASK && cm[gr * ldcm + gc] == 0) val = 0.f;
      C[gr * ldc + gc] = val;
    }
  }
}

// --------------------------------------------------------------- bf16 ---
// The same function on the tensor cores. x, w and dy move in 16-byte chunks
// of 8 values and the mask in 8-byte chunks (every contiguous width is a
// multiple of 8, so a chunk is wholly inside or outside the matrix); the
// next tile is loaded into registers while the tensor cores consume this
// one. At most 128 registers, so two blocks share an SM.
using wt::BK;
using wt::BM;
using wt::BN;
using wt::THREADS;

template <bool A_T, bool B_T, bool B_MASK, bool C_MASK>
__global__ void __launch_bounds__(THREADS, 2)
gemm_bf16(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
          const uint8_t* __restrict__ bm, const uint8_t* __restrict__ cm,
          __nv_bfloat16* __restrict__ C, int Mc, int Kc, int Nc, long long lda,
          long long ldb, long long ldbm, long long ldcm, long long ldc) {
  // shared tiles: A as [row][k] or (A_T) [k][row]; B as [k][col] or (B_T)
  // [col][k]; rows padded by 8 values (WMMA wants ldm % 8 == 0)
  constexpr int A_COLS = A_T ? BM : BK, A_LD = A_COLS + 8, A_ROWS = A_T ? BK : BM;
  constexpr int B_COLS = B_T ? BK : BN, B_LD = B_COLS + 8, B_ROWS = B_T ? BN : BK;
  __shared__ __align__(32) __nv_bfloat16 As[A_ROWS * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[B_ROWS * B_LD];
  __shared__ __align__(32) float Cs[THREADS / 32][16 * 16];
  constexpr int CHUNKS = (BM * BK) / (8 * THREADS);  // per thread, per tile
  static_assert(CHUNKS == (BK * BN) / (8 * THREADS), "A and B tiles differ");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  uint4 ra[CHUNKS], rb[CHUNKS];
  uint2 rm[CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + THREADS * i;
      {
        const int r = c / (A_COLS / 8), cc = (c % (A_COLS / 8)) * 8;
        const int gi = row0 + (A_T ? cc : r), gk = k0 + (A_T ? r : cc);
        ra[i] = (gi < Mc && gk < Kc)
                    ? *reinterpret_cast<const uint4*>(A + (A_T ? gk * lda + gi : gi * lda + gk))
                    : make_uint4(0, 0, 0, 0);
      }
      {
        const int r = c / (B_COLS / 8), cc = (c % (B_COLS / 8)) * 8;
        const int gk = k0 + (B_T ? cc : r), gj = col0 + (B_T ? r : cc);
        const bool in = gk < Kc && gj < Nc;
        rb[i] = in ? *reinterpret_cast<const uint4*>(B + (B_T ? gj * ldb + gk : gk * ldb + gj))
                   : make_uint4(0, 0, 0, 0);
        if (B_MASK)
          rm[i] = in ? *reinterpret_cast<const uint2*>(bm + (B_T ? gj * ldbm + gk : gk * ldbm + gj))
                     : make_uint2(0, 0);
      }
    }
  };
  auto stash = [&]() {  // registers -> shared memory, forming w*m in bf16
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + THREADS * i;
      *reinterpret_cast<uint4*>(As + (c / (A_COLS / 8)) * A_LD + (c % (A_COLS / 8)) * 8) = ra[i];
      uint4 o = rb[i];
      if (B_MASK) {
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&rb[i]);
        const uint8_t* mb = reinterpret_cast<const uint8_t*>(&rm[i]);
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o2[j] = __hmul2(w2[j], __floats2bfloat162_rn(static_cast<float>(mb[2 * j]),
                                                       static_cast<float>(mb[2 * j + 1])));
      }
      *reinterpret_cast<uint4*>(Bs + (c / (B_COLS / 8)) * B_LD + (c % (B_COLS / 8)) * 8) = o;
    }
  };

  wt::AccFrag acc[4][2];
  wt::zero(acc);
  load(0);
  for (int k0 = 0; k0 < Kc; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < Kc) load(k0 + BK);  // in flight during the products
    wt::mma_step<A_T, B_T>(acc, As, A_LD, Bs, B_LD, wm, wn);
    __syncthreads();
  }
  wt::store_acc<C_MASK>(acc, Cs[warp], C, row0 + wm * 64, col0 + wn * 32, Mc, Nc, ldc, cm,
                        ldcm, lane);
}

// every contiguous width and row stride a multiple of 8, 16-byte-aligned
// bf16 operands and 8-byte-aligned masks
bool bf16_ok(int Kc, int Nc, long long lda, long long ldb, long long ldbm, const void* A,
             const void* B, const void* bm) {
  return Kc % 8 == 0 && Nc % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 && ldbm % 8 == 0 &&
         wt::aligned(A, 16) && wt::aligned(B, 16) && wt::aligned(bm, 8);
}

template <bool A_T, bool B_T, bool B_MASK, bool C_MASK>
int launch_f32(const void* A, const void* B, const void* bm, const void* cm, void* C, int Mc,
               int Kc, int Nc, long long lda, long long ldb, long long ldbm, long long ldcm,
               long long ldc, void* stream) {
  dim3 grid((Nc + F_BN - 1) / F_BN, (Mc + F_BM - 1) / F_BM);
  gemm_f32<A_T, B_T, B_MASK, C_MASK><<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const uint8_t*>(bm), static_cast<const uint8_t*>(cm), static_cast<float*>(C),
      Mc, Kc, Nc, lda, ldb, ldbm, ldcm, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <bool A_T, bool B_T, bool B_MASK, bool C_MASK>
int launch_bf16(const void* A, const void* B, const void* bm, const void* cm, void* C, int Mc,
                int Kc, int Nc, long long lda, long long ldb, long long ldbm, long long ldcm,
                long long ldc, void* stream) {
  dim3 grid((Nc + BN - 1) / BN, (Mc + BM - 1) / BM);
  gemm_bf16<A_T, B_T, B_MASK, C_MASK><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const uint8_t*>(bm), static_cast<const uint8_t*>(cm),
      static_cast<__nv_bfloat16*>(C), Mc, Kc, Nc, lda, ldb, ldbm, ldcm, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point takes the matrices of its own product by their row
// strides; the mask m has w's shape (K, N).
//   forward: x (M, K), w (K, N)  -> out (M, N)
//   dX:      dy (M, N), w (K, N) -> dx (M, K)
//   dW:      x (M, K), dy (M, N) -> dw (K, N)
extern "C" int masked_matmul_f32(const void* x, const void* w, const void* m, void* out,
                                 int M, int K, int N, long long ldx, long long ldw,
                                 long long ldm, long long ldo, void* stream) {
  return launch_f32<false, false, true, false>(x, w, m, nullptr, out, M, K, N, ldx, ldw, ldm,
                                               0, ldo, stream);
}

extern "C" int masked_matmul_bf16(const void* x, const void* w, const void* m, void* out,
                                  int M, int K, int N, long long ldx, long long ldw,
                                  long long ldm, long long ldo, void* stream) {
  if (!bf16_ok(K, N, ldx, ldw, ldm, x, w, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false, false, true, false>(x, w, m, nullptr, out, M, K, N, ldx, ldw, ldm,
                                                0, ldo, stream);
}

extern "C" int masked_matmul_dx_f32(const void* dy, const void* w, const void* m, void* dx,
                                    int M, int K, int N, long long lddy, long long ldw,
                                    long long ldm, long long lddx, void* stream) {
  return launch_f32<false, true, true, false>(dy, w, m, nullptr, dx, M, N, K, lddy, ldw, ldm,
                                              0, lddx, stream);
}

extern "C" int masked_matmul_dx_bf16(const void* dy, const void* w, const void* m, void* dx,
                                     int M, int K, int N, long long lddy, long long ldw,
                                     long long ldm, long long lddx, void* stream) {
  if (!bf16_ok(N, K, lddy, ldw, ldm, dy, w, m)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<false, true, true, false>(dy, w, m, nullptr, dx, M, N, K, lddy, ldw, ldm,
                                               0, lddx, stream);
}

extern "C" int masked_matmul_dw_f32(const void* x, const void* dy, const void* m, void* dw,
                                    int M, int K, int N, long long ldx, long long lddy,
                                    long long ldm, long long lddw, void* stream) {
  return launch_f32<true, false, false, true>(x, dy, nullptr, m, dw, K, M, N, ldx, lddy, 0,
                                              ldm, lddw, stream);
}

extern "C" int masked_matmul_dw_bf16(const void* x, const void* dy, const void* m, void* dw,
                                     int M, int K, int N, long long ldx, long long lddy,
                                     long long ldm, long long lddw, void* stream) {
  // x is read along its rows (K wide) into the transposed A tile
  if (!(K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && lddy % 8 == 0 && wt::aligned(x, 16) &&
        wt::aligned(dy, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true, false, false, true>(x, dy, nullptr, m, dw, K, M, N, ldx, lddy, 0,
                                               ldm, lddw, stream);
}
