// nm_spmm: out = x @ decompress(vals, idx), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `nm_spmm` in
// src/repro/kernels/nm_spmm/nm_spmm.py (body `_kernel`): the matmul of a
// weight stored in the N:M compressed layout of
// src/repro/sparsity/sparse_params.py::nm_compress:
//     vals (K/m*n, N)  the kept values, group-major along K
//     idx  (K/m*n, N)  int8 offset of each kept value inside its M-group
//
// What bounds it on an H100: the product does the dense 2*M*K*N operations
// (the compressed weight saves bytes, not multiplies: Hopper's sparse
// tensor cores want their own metadata layout, which is later work), and
// at the slice's shapes (M = 16384 rows against 4096 x 4096 .. 11008 x
// 4096 weights) that is far above the ~295 operations per byte where the
// bf16 tensor cores stop waiting on HBM: it is bound by operations. The
// weight's bytes are the compressed vals + idx, n/m of the values plus one
// int8 each.
//
// Design: one thread block owns one output tile and loops over K inside
// the block, as masked_matmul. Each K step rebuilds the (BK, BN) weight
// tile in shared memory from its BK/m*n compressed rows: a thread takes a
// (group, column), reads the group's n values and offsets, and writes all m
// dense slots by compare-and-accumulate, dense[o] = sum_s vals[s] *
// (idx[s] == o), as the TPU kernel does in VMEM (no scatter; an offset
// outside [0, m) adds nothing; slot s = 0..n-1 in order). The dense tile
// then feeds the same products as masked_matmul:
//   * bf16: WMMA 16x16x16 with f32 accumulators. The next K step's x tile
//     (16-byte chunks) and its compressed entries are loaded into
//     registers while the current step's products run, so no K step waits
//     on a global load of the weight. n and m are template arguments, so
//     the entries stay in registers and each dense slot costs n compares.
//     A thread takes 4 adjacent columns of a group where N, the row
//     strides and the pointers allow (8-byte value loads, 4-byte offset
//     loads, 8-byte stores of the dense tile), else one column. K and x's
//     row stride must be multiples of 8 and x 16-byte aligned (else
//     cudaErrorInvalidValue);
//   * f32: the register-blocked SIMT GEMM with IEEE fp32 FMAs (no TF32).
// m must divide the K step (m in {1, 2, 4, 8}) and 1 <= n <= m.
#include "wmma_tile.cuh"

namespace {

constexpr int NMAX = 8;

// dense value of slot o of a group from its n kept (value, offset) pairs
__device__ __forceinline__ float slot(const float (&v)[NMAX], const int (&ix)[NMAX], int n,
                                      int o) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NMAX; ++s)
    if (s < n && ix[s] == o) acc += v[s];
  return acc;
}

// the n (value, offset) pairs of compressed group g, column j (zeros past
// the matrix)
template <typename T>
__device__ __forceinline__ void group(const T* __restrict__ vals,
                                      const int8_t* __restrict__ idx, long long ldv,
                                      long long ldi, int g, int j, int G, int N, int n,
                                      float (&v)[NMAX], int (&ix)[NMAX]) {
  const bool in = g < G && j < N;
#pragma unroll
  for (int s = 0; s < NMAX; ++s) {  // constant bounds keep v and ix in registers
    const long long row = static_cast<long long>(g) * n + s;
    const bool live = in && s < n;
    v[s] = live ? static_cast<float>(vals[row * ldv + j]) : 0.f;
    ix[s] = live ? static_cast<int>(idx[row * ldi + j]) : -1;
  }
}

// ---------------------------------------------------------------- f32 ---
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_T = 8, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
nm_f32_kernel(const float* __restrict__ x, const float* __restrict__ vals,
              const int8_t* __restrict__ idx, float* __restrict__ out, int M, int K, int N,
              int n, int m, long long ldx, long long ldv, long long ldi, long long ldo) {
  __shared__ float As[F_BK][F_BM + 4];  // x tile, transposed: As[k][row]
  __shared__ float Bs[F_BK][F_BN + 4];  // the dense weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * F_BM, col0 = blockIdx.x * F_BN;
  const int G = K / m, gpt = F_BK / m;  // groups in all, per K step

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
    for (int p = tid; p < gpt * F_BN; p += F_THREADS) {
      const int gl = p / F_BN, c = p % F_BN;
      float v[NMAX];
      int ix[NMAX];
      group(vals, idx, ldv, ldi, k0 / m + gl, col0 + c, G, N, n, v, ix);
      for (int o = 0; o < m; ++o) Bs[gl * m + o][c] = slot(v, ix, n, o);
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
using wt::BK;
using wt::BM;
using wt::BN;
using wt::THREADS;
constexpr int A_LD = BK + 8, B_LD = BN + 8;

// A K step's compressed entries for one thread, held in registers: UNITS
// units of one group and W adjacent columns, each with its NN (value,
// offset) rows, two bf16 values or four int8 offsets to a register. W = 4
// loads and stores 8 bytes of values (4 of offsets) at a time; W = 1 is
// for operands that are not aligned for that. A unit past the matrix has
// offsets -1, which add nothing.
template <int NN, int MM, int W>
struct Staged {
  static constexpr int PER_ROW = BN / W, TOTAL = (BK / MM) * PER_ROW;
  static constexpr int UNITS = TOTAL > THREADS ? TOTAL / THREADS : 1;
  static constexpr int VR = (W + 1) / 2, IR = (W + 3) / 4;
  static_assert(TOTAL % THREADS == 0 || TOTAL < THREADS, "units must tile the step");
  uint32_t v[UNITS][NN][VR];
  uint32_t ix[UNITS][NN][IR];

  __device__ __forceinline__ void load(const uint16_t* __restrict__ vals,
                                       const int8_t* __restrict__ idx, long long ldv,
                                       long long ldi, int g0, int col0, int G, int N, int tid) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int p = tid + THREADS * u;
      const int g = g0 + p / PER_ROW, j = col0 + (p % PER_ROW) * W;
      const bool in = p < TOTAL && g < G && j < N;  // W = 4 needs N % 4 == 0
#pragma unroll
      for (int s = 0; s < NN; ++s) {
        const long long row = static_cast<long long>(g) * NN + s;
        if (!in) {
#pragma unroll
          for (int r = 0; r < VR; ++r) v[u][s][r] = 0u;
#pragma unroll
          for (int r = 0; r < IR; ++r) ix[u][s][r] = 0xFFFFFFFFu;
        } else if constexpr (W == 4) {
          const uint2 t = *reinterpret_cast<const uint2*>(vals + row * ldv + j);
          v[u][s][0] = t.x;
          v[u][s][1] = t.y;
          ix[u][s][0] = *reinterpret_cast<const uint32_t*>(idx + row * ldi + j);
        } else {
          v[u][s][0] = vals[row * ldv + j];
          ix[u][s][0] = static_cast<uint8_t>(idx[row * ldi + j]);
        }
      }
    }
  }

  // the dense (BK, BN) tile into Bs: dense[o] = sum_s vals[s] * (idx[s] == o)
  __device__ __forceinline__ void decompress(__nv_bfloat16* Bs, int ld, int tid) const {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int p = tid + THREADS * u;
      if (p >= TOTAL) continue;
      const int gl = p / PER_ROW, c = (p % PER_ROW) * W;
#pragma unroll
      for (int o = 0; o < MM; ++o) {
        float acc[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          acc[w] = 0.f;
#pragma unroll
          for (int s = 0; s < NN; ++s) {
            const int off = static_cast<int8_t>((ix[u][s][w / 4] >> (8 * (w % 4))) & 0xFFu);
            if (off == o)
              acc[w] += __uint_as_float(((v[u][s][w / 2] >> (16 * (w % 2))) & 0xFFFFu) << 16);
          }
        }
        __nv_bfloat16* dst = Bs + (gl * MM + o) * ld + c;
        if constexpr (W == 4) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
          *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                      *reinterpret_cast<const uint32_t*>(&hi));
        } else {
          dst[0] = __float2bfloat16(acc[0]);
        }
      }
    }
  }
};

template <int NN, int MM, int W>
__global__ void __launch_bounds__(THREADS, 2)
nm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ vals,
               const int8_t* __restrict__ idx, __nv_bfloat16* __restrict__ out, int M, int K,
               int N, long long ldx, long long ldv, long long ldi, long long ldo) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[THREADS / 32][16 * 16];
  constexpr int CHUNKS = (BM * BK) / (8 * THREADS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int G = K / MM;

  uint4 ra[CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      ra[i] = (gr < M && gk < K) ? *reinterpret_cast<const uint4*>(x + gr * ldx + gk)
                                 : make_uint4(0, 0, 0, 0);
    }
  };

  Staged<NN, MM, W> st;
  wt::AccFrag acc[4][2];
  wt::zero(acc);
  load(0);
  st.load(vals, idx, ldv, ldi, 0, col0, G, N, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + THREADS * i;
      *reinterpret_cast<uint4*>(As + (c / (BK / 8)) * A_LD + (c % (BK / 8)) * 8) = ra[i];
    }
    st.decompress(Bs, B_LD, tid);
    __syncthreads();
    if (k0 + BK < K) {  // in flight during the products
      load(k0 + BK);
      st.load(vals, idx, ldv, ldi, (k0 + BK) / MM, col0, G, N, tid);
    }
    wt::mma_step<false, false>(acc, As, A_LD, Bs, B_LD, wm, wn);
    __syncthreads();
  }
  wt::store_acc<false>(acc, Cs[warp], out, row0 + wm * 64, col0 + wn * 32, M, N, ldo, nullptr,
                       0, lane);
}

bool nm_ok(int K, int n, int m) {
  return (m == 1 || m == 2 || m == 4 || m == 8) && n >= 1 && n <= m && K % m == 0;
}

}  // namespace

// x (M, K); vals and idx (K/m*n, N) with row strides ldv, ldi; out (M, N)
extern "C" int nm_spmm_f32(const void* x, const void* vals, const void* idx, void* out, int M,
                           int K, int N, int n, int m, long long ldx, long long ldv,
                           long long ldi, long long ldo, void* stream) {
  if (!nm_ok(K, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  nm_f32_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(vals),
      static_cast<const int8_t*>(idx), static_cast<float*>(out), M, K, N, n, m, ldx, ldv, ldi,
      ldo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nm_spmm_bf16(const void* x, const void* vals, const void* idx, void* out, int M,
                            int K, int N, int n, int m, long long ldx, long long ldv,
                            long long ldi, long long ldo, void* stream) {
  if (!(nm_ok(K, n, m) && K % 8 == 0 && ldx % 8 == 0 && wt::aligned(x, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  using Kernel = decltype(&nm_bf16_kernel<1, 1, 1>);
#define NM_ROW(W)                                                                          \
  {{},                                                                                     \
   {nm_bf16_kernel<1, 1, W>},                                                              \
   {nm_bf16_kernel<1, 2, W>, nm_bf16_kernel<2, 2, W>},                                     \
   {},                                                                                     \
   {nm_bf16_kernel<1, 4, W>, nm_bf16_kernel<2, 4, W>, nm_bf16_kernel<3, 4, W>,             \
    nm_bf16_kernel<4, 4, W>},                                                              \
   {}, {}, {},                                                                             \
   {nm_bf16_kernel<1, 8, W>, nm_bf16_kernel<2, 8, W>, nm_bf16_kernel<3, 8, W>,             \
    nm_bf16_kernel<4, 8, W>, nm_bf16_kernel<5, 8, W>, nm_bf16_kernel<6, 8, W>,             \
    nm_bf16_kernel<7, 8, W>, nm_bf16_kernel<8, 8, W>}}
  // every (n, m) with 1 <= n <= m, m in {1, 2, 4, 8}, at [w4][m][n - 1]
  static const Kernel table[2][9][8] = {NM_ROW(1), NM_ROW(4)};
#undef NM_ROW
  const bool w4 = N % 4 == 0 && ldv % 4 == 0 && ldi % 4 == 0 && wt::aligned(vals, 8) &&
                  wt::aligned(idx, 4);
  table[w4][m][n - 1]<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint16_t*>(vals),  // bf16 bits
      static_cast<const int8_t*>(idx), static_cast<__nv_bfloat16*>(out), M, K, N, ldx, ldv, ldi,
      ldo);
  return static_cast<int>(cudaGetLastError());
}
