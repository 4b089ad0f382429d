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
// tensor cores want their own 2:4 metadata layout, which is later work),
// and at the slice's shapes (M = 16384 rows against 4096 x 4096 .. 11008 x
// 4096 weights) that is far above the ~295 operations per byte where the
// bf16 tensor cores stop waiting on HBM: it is bound by operations. The
// weight's bytes are the compressed vals + idx, n/m of the values plus one
// int8 each.
//
// Design: each K step rebuilds the dense weight tile from its compressed
// rows by compare-and-accumulate, dense[o] = sum_s vals[s] * (idx[s] == o),
// as the TPU kernel does in VMEM (no scatter; an offset outside [0, m) adds
// nothing; slots s = 0..n-1 summed in order, from 0, in the weight's dtype).
//   * bf16: the wgmma main loop of gemm.cuh, shared with masked_matmul.cu
//     (a 256 x 128 output tile, four consumer warpgroups of
//     wgmma.m64n128k16, a TMA ring filled by a lone warp). Each stage holds
//     x's 256 x 64 tile (K-major, 128-byte swizzle) and the step's
//     compressed rows of vals (bf16, rows of 256 bytes) and idx (int8,
//     rows of 128 bytes), both unswizzled, by TMA. The B-tile policy NmB
//     has the consumers decompress them into the dense 64 x 128 MN-major
//     tile in the 128-byte swizzle wgmma reads: each thread takes two rows
//     and 8 adjacent columns, reads the row's group's n slots, selects and
//     adds them as bf16 pairs (four offsets compared at a time) and stores
//     16-byte chunks at their swizzled place, while the previous stage's
//     products run; then the fence to the async proxy and the named
//     barrier, as masked_matmul's mask multiply. The dense tile lives
//     outside the ring, in DENSE_BUFS buffers used in turn; the ring is as
//     deep as shared memory allows for the (n, m) at hand (gemm::stages_for:
//     4 at 2:4, 3 at 8:8). n and m are template arguments, over every
//     (n, m) with m in {1, 2, 4, 8}. It takes what the TMA takes: K, N and
//     the row strides of x and vals multiples of 8, idx's a multiple of 16,
//     16-byte-aligned operands (else cudaErrorInvalidValue);
//   * f32: the register-blocked SIMT GEMM with IEEE fp32 FMAs (no TF32).
// m must divide the K step (m in {1, 2, 4, 8}) and 1 <= n <= m.
#include "gemm.cuh"

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
// The dense B tile lives outside the ring, in DENSE_BUFS buffers used in
// turn, so a stage holds only what the TMA brings and the ring is 4 deep
// at 2:4 (a dense tile in each stage left room for 3 and ran slower,
// PERF.md). Three buffers suffice: a consumer forming step kt's tile has
// met every other at the named barrier of step kt - 1, which each reached
// after its products of step kt - 3 were done (wgmma_wait<1>).
constexpr int DENSE_BUFS = 3;

// 0x80 in each byte of t that is zero, 0 in the others (exact per byte)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t t) {
  return ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t | 0x7F7F7F7Fu);
}

// prmt in its default mode: selector nibble 8 + b gives byte b's sign bit
// replicated over a byte, so 0x9988 widens the flags of bytes 0 and 1 to
// two 16-bit masks, 0xBBAA those of bytes 2 and 3
__device__ __forceinline__ uint32_t widen(uint32_t flags, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(flags), "r"(0u), "r"(sel));
  return r;
}

template <int NN, int MM>
struct NmB {
  struct Maps {
    CUtensorMap vals, idx;
  };
  static constexpr int ROWS = gm::BK / MM * NN;  // compressed rows of a step
  static constexpr int V_BYTES = ROWS * gm::BN * 2, I_BYTES = ROWS * gm::BN;
  static constexpr bool B_MN = true, FORMS = true;
  static constexpr int TX = V_BYTES + I_BYTES;
  static constexpr int STAGE = TX, EXTRA = DENSE_BUFS * gm::B_BYTES;
  static constexpr int STAGES = gm::stages_for(STAGE, EXTRA);
  static_assert(V_BYTES % 1024 == 0 && I_BYTES % 1024 == 0, "1024-byte stage parts");
  static_assert(gm::BK * (gm::BN / 8) == 2 * gm::CTHREADS, "two dense chunks a thread");

  static __device__ __forceinline__ void load(uint8_t* sb, const Maps& maps, uint64_t* bar,
                                              int k0, int col0, int /*z: one slab*/) {
    hp::tma_load_2d(sb, &maps.vals, bar, col0, k0 / MM * NN);
    hp::tma_load_2d(sb + V_BYTES, &maps.idx, bar, col0, k0 / MM * NN);
  }

  // the dense tile: thread tid writes rows r0 and r0 + 1 (r0 = 2 (tid / 16))
  // at columns 8c .. 8c + 7 (c = tid % 16), four bf16 pairs a row, from the
  // n slots of the row's group. Slot s adds its value where its offset byte
  // equals the row's offset o: the bytes of idx ^ (o * 0x01010101) that
  // are zero flag the matches, and prmt's sign replication widens each flag
  // to its value's 16 bits. The sum is taken in bf16 from 0, slot after
  // slot, as the TPU kernel's `dense + where(onehot, vals, 0)` in the
  // weight's dtype.
  static __device__ __forceinline__ const uint8_t* form(uint8_t* sb, uint8_t* extra, int kt,
                                                        int tid) {
    uint8_t* dense = extra + (kt % DENSE_BUFS) * gm::B_BYTES;
    const uint8_t* sv = sb;  // the step's compressed rows: vals, then idx
    const uint8_t* si = sv + V_BYTES;
    const int c = tid % 16, r0 = 2 * (tid / 16);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row at a time: few registers live beside the products
      const int row = r0 + r, grow = (row / MM) * NN;  // the group's first compressed row
      const uint32_t o4 = static_cast<uint32_t>(row % MM) * 0x01010101u;
      __nv_bfloat162 acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __float2bfloat162_rn(0.f);
#pragma unroll
      for (int s = 0; s < NN; ++s) {
        const uint4 v = *reinterpret_cast<const uint4*>(sv + (grow + s) * (gm::BN * 2) + c * 16);
        const uint2 ix = *reinterpret_cast<const uint2*>(si + (grow + s) * gm::BN + c * 8);
        const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
        const uint32_t hit[2] = {zero_bytes(ix.x ^ o4), zero_bytes(ix.y ^ o4)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // 0xFFFF over each value of pair j whose offset matched
          const uint32_t sel = vw[j] & widen(hit[j / 2], (j % 2) ? 0xBBAAu : 0x9988u);
          acc[j] = __hadd2(acc[j], *reinterpret_cast<const __nv_bfloat162*>(&sel));
        }
      }
      *reinterpret_cast<uint4*>(dense + (c / 8) * gm::ATOM + row * 128 +
                                (((c % 8) ^ (row & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(acc);
    }
    return dense;
  }
};

template <int NN, int MM>
int launch_bf16(const void* x, const void* vals, const void* idx, void* out, int M, int K, int N,
                long long ldx, long long ldv, long long ldi, long long ldo, void* stream) {
  CUtensorMap map_x{};
  typename NmB<NN, MM>::Maps maps{};
  const int rows = K / MM * NN;
  if (!(gm::map_a(&map_x, x, M, K, ldx, false) &&
        gm::map2(&maps.vals, vals, rows, N, ldv, gm::BN, NmB<NN, MM>::ROWS) &&
        gm::map2(&maps.idx, idx, rows, N, ldi, gm::BN, NmB<NN, MM>::ROWS, true)))
    return static_cast<int>(cudaErrorInvalidValue);
  return gm::launch<false, NmB<NN, MM>, gm::EPI_NONE>(map_x, maps, nullptr, out, M, K, N, 0, ldo,
                                                      stream);
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
  // what the TMA takes: 16-byte-aligned bases, row strides of 16 bytes;
  // and N % 8 == 0, so an output pair is wholly in or out
  if (!(nm_ok(K, n, m) && K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && ldv % 8 == 0 &&
        ldi % 16 == 0 && hp::aligned(x, 16) && hp::aligned(vals, 16) && hp::aligned(idx, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = decltype(&launch_bf16<1, 1>);
  // every (n, m) with 1 <= n <= m, m in {1, 2, 4, 8}, at [m][n - 1]
  static const Launch table[9][8] = {
      {},
      {launch_bf16<1, 1>},
      {launch_bf16<1, 2>, launch_bf16<2, 2>},
      {},
      {launch_bf16<1, 4>, launch_bf16<2, 4>, launch_bf16<3, 4>, launch_bf16<4, 4>},
      {}, {}, {},
      {launch_bf16<1, 8>, launch_bf16<2, 8>, launch_bf16<3, 8>, launch_bf16<4, 8>,
       launch_bf16<5, 8>, launch_bf16<6, 8>, launch_bf16<7, 8>, launch_bf16<8, 8>}};
  return table[m][n - 1](x, vals, idx, out, M, K, N, ldx, ldv, ldi, ldo, stream);
}
