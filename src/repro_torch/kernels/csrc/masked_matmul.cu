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
// bound by operations: the tensor cores have to be kept fed, and each
// operand tile has to be reused from L2 by the blocks that run together.
//
// One generic tile GEMM C = A @ B serves the three products, templated on
// how A and B are laid out and where the mask goes, so they share one tile
// loop. One thread block owns one output tile and loops over the reduction
// inside the block (the TPU kernel's sequential K grid axis and its f32
// VMEM accumulator become that loop and registers). Every operand has a
// row stride (a (d, H, hd) leaf is read as (d, H*hd) without a copy) and
// ragged edges are handled (11008 = 86*128; 777-row cases).
//   * f32: a register-blocked SIMT GEMM with IEEE fp32 FMAs; no TF32, so it
//     holds the reference's 2e-5 tolerance.
//   * bf16: wgmma on a 256 x 128 output tile, 64-deep reduction steps,
//     f32 accumulators, fed by TMA through a ring of G_STAGES shared-memory
//     stages tracked by mbarriers (warp specialisation). One warp issues
//     the TMA loads as soon as a stage is free: x and dy in the 128-byte
//     swizzle that wgmma reads, K-major as A of the forward and dX,
//     MN-major as dW's x^T and dy; w MN-major in the forward, K-major in
//     dX; and the uint8 mask tile, unswizzled, beside w in the same stage.
//     Four consumer warpgroups issue wgmma.m64n128k16 on their 64-row
//     quarters and keep one stage's products in flight while they start
//     the next. TMA writes shared memory as it is, so w * m is formed
//     there: in the forward and dX the consumers multiply the w tile by
//     the mask tile in place (two 16-byte chunks each, while the previous
//     stage's products run), fence their stores to the async proxy and meet
//     at a named barrier before their wgmma reads the tile. Nothing
//     weight-sized is written to HBM. Two other placements of that multiply
//     were measured and dropped (PERF.md): a producer warpgroup that
//     loaded w and m with plain loads and stored w * m into the stage was
//     bound by their latency, and a producer warpgroup that multiplied the
//     TMA-loaded tile in place, on a 128-row tile, was slower still. Blocks
//     walk the output tiles in groups of G_GROUP tile rows, so the blocks
//     on the card at one time share A and B tiles in L2. The epilogue
//     writes bf16 pairs straight from the accumulators; dW selects 0 where
//     the mask is 0. The tensor maps are encoded on the host in each entry
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

#include "hopper.cuh"

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
// C (Mc x Nc) = A @ B on the tensor cores. A_MN / B_MN: the operand is
// MN-major (A(i, r) = A[r*lda + i], B(r, j) = B[r*ldb + j]) instead of
// K-major (A[i*lda + r], B[j*ldb + r]). With B_MASK, B is w and bm (B's
// layout) is multiplied into it in shared memory.
constexpr int G_BM = 256, G_BN = 128, G_BK = 64, G_STAGES = 4, G_GROUP = 8;
constexpr int G_CONSUMERS = G_BM / 64;              // warpgroups, 64 rows each
constexpr int G_A_BYTES = G_BM * G_BK * 2;          // 32 KB
constexpr int G_B_BYTES = G_BK * G_BN * 2;          // 16 KB
constexpr int G_M_BYTES = G_BK * G_BN;              // the uint8 mask tile, 8 KB
constexpr int G_STAGE = G_A_BYTES + G_B_BYTES + G_M_BYTES;  // 1024-byte multiples
constexpr int G_ATOM = 64 * 128;                    // 64 rows of 128 bytes
constexpr size_t G_SMEM = 1024 + size_t(G_STAGES) * G_STAGE + 2 * G_STAGES * sizeof(uint64_t);

// warpgroups 0-3 consume (and form w * m); one more warp issues the TMA loads
constexpr int G_CTHREADS = 128 * G_CONSUMERS, G_THREADS = G_CTHREADS + 32;

template <bool A_MN, bool B_MN, bool B_MASK, bool C_MASK>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
           const __grid_constant__ CUtensorMap map_m, const uint8_t* __restrict__ cm,
           __nv_bfloat16* __restrict__ C, int Mc, int Kc, int Nc, long long ldcm, long long ldc) {
  extern __shared__ uint8_t g_smem_raw[];
  uint8_t* smem = g_smem_raw + ((1024 - (hp::smem_u32(g_smem_raw) & 1023)) & 1023);
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem + G_STAGES * G_STAGE);
  uint64_t* empty = loaded + G_STAGES;
  const int tid = threadIdx.x;

  // output tile: groups of G_GROUP tile rows, walked column by column, so
  // the blocks on the card at one time share their A and B tiles in L2
  const int nM = (Mc + G_BM - 1) / G_BM, nN = (Nc + G_BN - 1) / G_BN;
  const int per_group = G_GROUP * nN, in_group = blockIdx.x % per_group;
  const int first_m = (blockIdx.x / per_group) * G_GROUP;
  const int gm = min(nM - first_m, G_GROUP);
  const int row0 = (first_m + in_group % gm) * G_BM, col0 = (in_group / gm) * G_BN;
  const int nk = (Kc + G_BK - 1) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hp::mbar_init(&loaded[s], 1);
      hp::mbar_init(&empty[s], 4 * G_CONSUMERS);  // one per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G_CTHREADS) {  // ------------------------------------- TMA warp ---
    if (tid == G_CTHREADS)
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES, k0 = kt * G_BK;
        hp::mbar_wait(&empty[s], ((kt / G_STAGES) & 1) ^ 1);
        uint8_t* sa = smem + s * G_STAGE;
        uint8_t* sb = sa + G_A_BYTES;
        hp::mbar_expect_tx(&loaded[s], G_A_BYTES + G_B_BYTES + (B_MASK ? G_M_BYTES : 0));
        if (A_MN) {  // 64-wide atoms of [k][row]
          for (int a = 0; a < G_CONSUMERS; ++a)
            hp::tma_load_2d(sa + a * G_ATOM, &map_a, &loaded[s], row0 + 64 * a, k0);
        } else {  // G_BM rows of 64 k
          hp::tma_load_2d(sa, &map_a, &loaded[s], k0, row0);
        }
        if (B_MN) {  // two 64-wide atoms of [k][col]
          hp::tma_load_2d(sb, &map_b, &loaded[s], col0, k0);
          hp::tma_load_2d(sb + G_ATOM, &map_b, &loaded[s], col0 + 64, k0);
        } else {  // 128 rows (output columns) of 64 k
          hp::tma_load_2d(sb, &map_b, &loaded[s], k0, col0);
        }
        if (B_MASK)  // the mask tile in B's layout, unswizzled
          hp::tma_load_2d(sb + G_B_BYTES, &map_m, &loaded[s], B_MN ? col0 : k0,
                          B_MN ? k0 : col0);
      }
  } else {  // ---------------------------------------------------- consumers ---
    const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % G_STAGES;
      hp::mbar_wait(&loaded[s], (kt / G_STAGES) & 1);
      uint8_t* sb = smem + s * G_STAGE + G_A_BYTES;
      if (B_MASK) {
        // w * m in place, while the previous stage's products run. The B
        // tile: MN-major (forward) 64 rows k of 128 columns in two atoms,
        // K-major (dX) 128 rows (w's rows) of 64 k in one; chunk (r, e) of
        // 8 values sits at its swizzled place in B and at r * ROW + e in
        // the mask tile.
        constexpr int ROWS = B_MN ? G_BK : G_BN, ROW = B_MN ? G_BN : G_BK, ROW_CH = ROW / 8;
        const uint8_t* sm = sb + G_B_BYTES;
#pragma unroll
        for (int i = 0; i < ROWS * ROW_CH / G_CTHREADS; ++i) {
          const int c = tid + G_CTHREADS * i, r = c / ROW_CH, e = (c % ROW_CH) * 8;
          uint4* wp = reinterpret_cast<uint4*>(
              sb + (e / 64) * (ROWS * 128) + r * 128 + ((((e % 64) / 8) ^ (r & 7)) << 4));
          const uint2 mv = *reinterpret_cast<const uint2*>(sm + r * ROW + e);
          uint4 o = *wp;
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
          const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mv);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o2[j] = __hmul2(o2[j], __floats2bfloat162_rn(static_cast<float>(mb[2 * j]),
                                                         static_cast<float>(mb[2 * j + 1])));
          *wp = o;
        }
        hp::fence_proxy_async();  // the stores, to wgmma's async proxy
        hp::named_sync(1, G_CTHREADS);
      }
      const uint8_t* sa = smem + s * G_STAGE + wg * G_ATOM;  // this warpgroup's 64 rows
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk) {
        const uint64_t da = A_MN ? hp::desc(sa + kk * 16 * 128, 128, G_ATOM)
                                 : hp::desc(sa + kk * 32, 128, 0);
        const uint64_t db = B_MN ? hp::desc(sb + kk * 16 * 128, 128, G_ATOM)
                                 : hp::desc(sb + kk * 32, 128, 0);
        hp::wgmma_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, 1);
      }
      hp::wgmma_commit();
      // one group stays in flight: the previous stage's products are done
      hp::wgmma_wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0) hp::mbar_arrive(&empty[(kt + G_STAGES - 1) % G_STAGES]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    // acc[4j + 2h + e]: row 16 warp + g + 8h, column 8j + 2q + e
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int gc = col0 + 8 * j + 2 * q;
      if (gc >= Nc) continue;  // Nc % 8 == 0: a pair is wholly in or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wg * 64 + warp * 16 + g + 8 * h;
        if (gr >= Mc) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (C_MASK) {
          const uint8_t* mp = cm + gr * ldcm + gc;
          if (mp[0] == 0) v0 = 0.f;
          if (mp[1] == 0) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(C + gr * ldc + gc) = __floats2bfloat162_rn(v0, v1);
      }
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

// A_T / B_T as in gemm_f32: A_T reads A MN-major, B_T reads B K-major.
// Every operand by TMA: a (rows x cols) matrix with row stride ld is the
// map {cols, rows}; its boxes are 64 values wide.
template <bool A_T, bool B_T, bool B_MASK, bool C_MASK>
int launch_bf16(const void* A, const void* B, const void* bm, const void* cm, void* C, int Mc,
                int Kc, int Nc, long long lda, long long ldb, long long ldbm, long long ldcm,
                long long ldc, void* stream) {
  auto map2 = [](CUtensorMap* map, const void* base, int rows, int cols, long long ld,
                 uint32_t box_rows, bool bytes = false) {
    const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
    const uint64_t stride[1] = {uint64_t(ld) * (bytes ? 1 : 2)};
    const uint32_t box[2] = {bytes && box_rows == 64 ? 128u : 64u, box_rows};
    return hp::make_map(map, base, 2, dims, stride, box, bytes);
  };
  CUtensorMap map_a{}, map_b{}, map_m{};
  // A: MN-major is (Kc rows, Mc cols) read in 64 x 64 boxes, K-major
  // (Mc rows, Kc cols) in G_BM-row boxes; B likewise with Nc and 128
  bool ok = A_T ? map2(&map_a, A, Kc, Mc, lda, 64) : map2(&map_a, A, Mc, Kc, lda, G_BM);
  ok = ok && (B_T ? map2(&map_b, B, Nc, Kc, ldb, 128) : map2(&map_b, B, Kc, Nc, ldb, 64));
  // the mask in B's layout: one box per stage (64 x 128 or 128 x 64 bytes)
  if (B_MASK)
    ok = ok && (B_T ? map2(&map_m, bm, Nc, Kc, ldbm, 128, true)
                    : map2(&map_m, bm, Kc, Nc, ldbm, 64, true));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_wgmma<A_T, !B_T, B_MASK, C_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)((Mc + G_BM - 1) / G_BM) * ((Nc + G_BN - 1) / G_BN);
  kernel<<<(unsigned)tiles, G_THREADS, G_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_m, static_cast<const uint8_t*>(cm), static_cast<__nv_bfloat16*>(C), Mc,
      Kc, Nc, ldcm, ldc);
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
  if (!(K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 && lddy % 8 == 0 && hp::aligned(x, 16) &&
        hp::aligned(dy, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true, false, false, true>(x, dy, nullptr, m, dw, K, M, N, ldx, lddy, 0,
                                               ldm, lddw, stream);
}
