// Pieces shared by the bf16 WMMA GEMM kernels (masked_matmul.cu,
// nm_spmm.cu): one 256-thread block owns a 128 x 128 output tile and walks
// the reduction in 32-deep steps; its 8 warps each own a 64 x 32 tile of
// 4 x 2 WMMA 16x16x16 accumulators in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace wt {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <bool COL>
using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             std::conditional_t<COL, wmma::col_major, wmma::row_major>>;
template <bool COL>
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             std::conditional_t<COL, wmma::col_major, wmma::row_major>>;

__device__ __forceinline__ void zero(AccFrag (&acc)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// One BK-deep step of the warp's 64 x 32 tile. As holds the A tile as
// [row][k] (A_COL false, leading dimension a_ld) or [k][row] (A_COL true);
// Bs holds the B tile as [k][col] (B_COL false) or [col][k] (B_COL true).
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void mma_step(AccFrag (&acc)[4][2], const __nv_bfloat16* As,
                                         int a_ld, const __nv_bfloat16* Bs, int b_ld,
                                         int wm, int wn) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    BFrag<B_COL> b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 32 + j * 16;
      wmma::load_matrix_sync(b[j], B_COL ? Bs + c * b_ld + ks : Bs + ks * b_ld + c, b_ld);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16;
      AFrag<A_COL> a;
      wmma::load_matrix_sync(a, A_COL ? As + ks * a_ld + r : As + r * a_ld + ks, a_ld);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
    }
  }
}

// A warp's 64 x 32 accumulator tile -> bf16 output, through a 16 x 16 f32
// staging tile in shared memory, masking the ragged edge. With MASKED the
// output is 0 wherever the uint8 mask cm is 0 (exactly 0, never -0 or NaN).
template <bool MASKED>
__device__ __forceinline__ void store_acc(AccFrag (&acc)[4][2], float* cs,
                                          __nv_bfloat16* __restrict__ out, int r0, int c0,
                                          int M, int N, long long ldo,
                                          const uint8_t* __restrict__ cm, long long ldcm,
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
        if (gr < M && gc < N) {
          float val = cs[t];
          if (MASKED && cm[gr * ldcm + gc] == 0) val = 0.f;
          out[gr * ldo + gc] = __float2bfloat16(val);
        }
      }
      __syncwarp();
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace wt
