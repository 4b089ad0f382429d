// masked_matmul: out = x @ (w * m), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `masked_matmul` in
// src/repro/kernels/masked_matmul/masked_matmul.py (body `_kernel`): the
// contraction of every masked linear of a sparse block.
//
// What bounds it on an H100: at the slice's shapes (M = 16384 rows against
// 4096x4096, 4096x11008 and 11008x4096 weights) the product does about 2*M
// operations per weight byte, far above the ~295 operations per byte where
// bf16 tensor cores stop waiting on HBM, so it is bound by operations.
//
// Design: one thread block owns one output tile and loops over K inside
// the block (the TPU kernel's sequential K grid axis and its f32 VMEM
// accumulator become that loop and registers). Each K step loads the w
// tile and the uint8 mask tile together and forms w*m in w's dtype on the
// way into shared memory, so nothing weight-sized is written back. The
// kernel masks the ragged edges itself and takes a row stride for every
// operand (a (d, H, hd) leaf is read as (d, H*hd) without a copy).
//   * f32: a register-blocked SIMT GEMM with IEEE fp32 FMAs; no TF32, so it
//     holds the reference's 2e-5 tolerance.
//   * bf16: WMMA 16x16x16 tensor-core products with f32 accumulators, cast
//     to bf16 at the store, 16-byte vector loads with the next K tile
//     prefetched into registers. It takes 16-byte-aligned operands only
//     (K, N and the row strides multiples of 8, as in every linear of the
//     model) and refuses others with cudaErrorInvalidValue.
// No TMA, wgmma or warp specialisation yet; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- f32 ---
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_T = 8, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const uint8_t* __restrict__ m, float* __restrict__ out,
              int M, int K, int N, long long ldx, long long ldw,
              long long ldm, long long ldo) {
  __shared__ float As[F_BK][F_BM + 4];  // x tile, transposed: As[k][row]
  __shared__ float Bs[F_BK][F_BN + 4];  // (w*m) tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * F_BM, col0 = blockIdx.x * F_BN;

  float acc[F_T][F_T];
#pragma unroll
  for (int i = 0; i < F_T; ++i)
#pragma unroll
    for (int j = 0; j < F_T; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < (F_BM * F_BK) / F_THREADS; ++i) {
      const int e = tid + F_THREADS * i;
      const int r = e / F_BK, kk = e % F_BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? x[gr * ldx + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (F_BN * F_BK) / F_THREADS; ++i) {
      const int e = tid + F_THREADS * i;
      const int kk = e / F_BN, c = e % F_BN;
      const int gk = k0 + kk, gc = col0 + c;
      float v = 0.f;
      if (gk < K && gc < N) v = w[gk * ldw + gc] * static_cast<float>(m[gk * ldm + gc]);
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
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < F_T; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) out[gr * ldo + gc] = acc[i][j];
    }
  }
}

// --------------------------------------------------------------- bf16 ---
constexpr int H_BM = 128, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int A_LD = H_BK + 8;  // padded rows; WMMA wants ldm % 8 == 0
constexpr int B_LD = H_BN + 8;

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// A warp's 64 x 32 accumulator tile -> bf16 output, through a 16 x 16
// f32 staging tile in shared memory, masking the ragged edge.
__device__ __forceinline__ void store_acc(AccFrag (&acc)[4][2], float* cs,
                                          __nv_bfloat16* __restrict__ out, int r0,
                                          int c0, int M, int N, long long ldo,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32) {
        const int gr = r0 + i * 16 + t / 16;
        const int gc = c0 + j * 16 + t % 16;
        if (gr < M && gc < N) out[gr * ldo + gc] = __float2bfloat16(cs[t]);
      }
      __syncwarp();
    }
  }
}

// 16-byte-aligned operands (K, N and the row strides multiples of 8): x and
// w move in 16-byte chunks of 8 values, the mask in 8-byte chunks, and the
// next K tile is loaded into registers while the tensor cores consume this
// one. At most 128 registers, so two blocks share an SM.
__global__ void __launch_bounds__(H_THREADS, 2)
mm_bf16_vec_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const uint8_t* __restrict__ m, __nv_bfloat16* __restrict__ out,
                   int M, int K, int N, long long ldx, long long ldw,
                   long long ldm, long long ldo) {
  __shared__ __align__(32) __nv_bfloat16 As[H_BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[H_BK * B_LD];
  __shared__ __align__(32) float Cs[H_THREADS / 32][16 * 16];
  constexpr int CHUNKS = (H_BM * H_BK) / (8 * H_THREADS);  // per thread, per tile
  static_assert(CHUNKS == (H_BK * H_BN) / (8 * H_THREADS), "A and B tiles differ");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * H_BM, col0 = blockIdx.x * H_BN;

  uint4 ra[CHUNKS], rw[CHUNKS];
  uint2 rm[CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + H_THREADS * i;
      const int r = c / (H_BK / 8), kc = (c % (H_BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      ra[i] = (gr < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + gr * ldx + gk)
                  : make_uint4(0, 0, 0, 0);
      const int kr = c / (H_BN / 8), nc = (c % (H_BN / 8)) * 8;
      const int wk = k0 + kr, wc = col0 + nc;
      const bool in = wk < K && wc < N;
      rw[i] = in ? *reinterpret_cast<const uint4*>(w + wk * ldw + wc) : make_uint4(0, 0, 0, 0);
      rm[i] = in ? *reinterpret_cast<const uint2*>(m + wk * ldm + wc) : make_uint2(0, 0);
    }
  };
  auto stash = [&]() {  // registers -> shared memory, forming w*m in bf16
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + H_THREADS * i;
      *reinterpret_cast<uint4*>(As + (c / (H_BK / 8)) * A_LD + (c % (H_BK / 8)) * 8) = ra[i];
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&rw[i]);
      const uint8_t* mb = reinterpret_cast<const uint8_t*>(&rm[i]);
      uint4 o;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o2[j] = __hmul2(w2[j], __floats2bfloat162_rn(static_cast<float>(mb[2 * j]),
                                                     static_cast<float>(mb[2 * j + 1])));
      *reinterpret_cast<uint4*>(Bs + (c / (H_BN / 8)) * B_LD + (c % (H_BN / 8)) * 8) = o;
    }
  };

  AccFrag acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += H_BK) {
    stash();
    __syncthreads();
    if (k0 + H_BK < K) load(k0 + H_BK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < H_BK; ks += 16) {
      BFrag b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        AFrag a;
        wmma::load_matrix_sync(a, As + (wm * 64 + i * 16) * A_LD + ks, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  store_acc(acc, Cs[warp], out, row0 + wm * 64, col0 + wn * 32, M, N, ldo, lane);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int masked_matmul_f32(const void* x, const void* w, const void* m,
                                 void* out, int M, int K, int N, long long ldx,
                                 long long ldw, long long ldm, long long ldo,
                                 void* stream) {
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  mm_f32_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const uint8_t*>(m), static_cast<float*>(out), M, K, N, ldx,
      ldw, ldm, ldo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int masked_matmul_bf16(const void* x, const void* w, const void* m,
                                  void* out, int M, int K, int N, long long ldx,
                                  long long ldw, long long ldm, long long ldo,
                                  void* stream) {
  if (!(K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && ldw % 8 == 0 && ldm % 8 == 0 &&
        aligned(x, 16) && aligned(w, 16) && aligned(m, 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
  mm_bf16_vec_kernel<<<grid, H_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const uint8_t*>(m), static_cast<__nv_bfloat16*>(out), M, K, N,
      ldx, ldw, ldm, ldo);
  return static_cast<int>(cudaGetLastError());
}
