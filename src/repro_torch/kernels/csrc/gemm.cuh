// The bf16 GEMM main loop shared by masked_matmul.cu and nm_spmm.cu, for
// Hopper (sm_90a): C (Mc x Nc) = A @ B with f32 accumulators, bf16 out.
//
// One block owns a BM x BN output tile of one slab z = blockIdx.y (a
// batched product, such as the experts of an MoE layer, launches one grid
// whose y runs over the slabs; a 2-D product is the one slab z = 0) and
// walks the reduction in 64-deep steps through a ring of STAGES shared-memory stages tracked by mbarriers
// (`loaded`: the stage's TMA bytes have landed; `empty`: every consumer warp
// is done with it). The tile is a template argument (Tile<BM, BN>): the
// compiled set is 256 x 128 (the default), 128 x 128 and 128 x 64
// (with_tile; kernels/validation.py holds the same list), and BK stays 64,
// the 128-byte swizzle row of bf16. Warp specialisation: a lone warp issues the TMA loads as
// soon as a stage is free (A's BM x 64 tile in the 128-byte swizzle that
// wgmma reads, K-major or MN-major, and whatever the B-tile policy loads);
// BM / 64 consumer warpgroups wait for a stage, let the policy turn what landed
// into the 64 x BN B tile that wgmma reads, and issue wgmma.m64n{BN}k16 on
// their 64-row parts, keeping one stage's products in flight while they
// form and start the next. Blocks walk the output tiles in groups of GROUP
// tile rows, column by column, so the blocks on the card at one time share
// their A and B tiles in L2. The epilogue writes bf16 pairs straight from
// the accumulators, as they are (EPI_NONE), with 0 wherever the uint8 mask
// `ce` is 0 (EPI_MASK), or times the bf16 matrix `ce`, read as a pair beside
// the output pair and multiplied in f32 before the one rounding (EPI_SCALE).
// Each output is a sum in a fixed order along K, whatever the tile: a repeated launch gives the same
// bits, and so does a launch on another tile of the set. The A operand and the masked and plain B policies read through
// rank-3 tensor maps (columns, rows, slabs): a block's boxes stay inside its
// slab, and the TMA fills rows past the slab's end with zeros, so a slab's
// product is the 2-D launch on that slab alone, bit for bit.
//
// A B-tile policy BT supplies:
//   T                      its Tile<BM, BN>;
//   Maps                   its tensor maps, passed by value to the kernel;
//   B_MN                   whether the B tile wgmma reads is MN-major
//                          (BN / 64 atoms of 64 columns, [k][col]) or K-major
//                          (BN rows of 64 k);
//   STAGE, TX              the bytes it keeps in a stage beside A's tile
//                          (a multiple of 1024) and the TMA bytes it loads;
//   EXTRA                  bytes it keeps outside the ring (multiple of 1024);
//   STAGES                 the ring's depth (Tile::stages_for: what fits);
//   load(sb, maps, bar, k0, col0, z)   the producer's TMA loads for step
//                          k0 of slab z into the stage's B part `sb`;
//   FORMS, form(sb, extra, kt, tid) whether the consumers (thread tid of
//                          CTHREADS) rewrite what landed before wgmma reads
//                          it, and the B tile they made; the kernel then
//                          fences their stores to the async proxy and meets
//                          at a named barrier. A FORMS-free policy's B tile
//                          is `sb` as the TMA wrote it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace gm {

constexpr int BK = 64, GROUP = 8;
constexpr int ATOM = 64 * 128;                      // 64 rows of 128 bytes
constexpr int SMEM_MAX = hp::SMEM_MAX;              // a block's shared memory on sm_90
constexpr int MAX_STAGES = 4;

// the epilogue: C as it is, C where the mask is not 0, or C times a matrix
enum Epilogue { EPI_NONE = 0, EPI_MASK = 1, EPI_SCALE = 2 };

template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int CONSUMERS = BM / 64;                 // warpgroups, 64 rows each
  static constexpr int CTHREADS = 128 * CONSUMERS, THREADS = CTHREADS + 32;  // + the TMA warp
  static constexpr int A_BYTES = BM * BK * 2;               // 32 KB at BM 256
  static constexpr int B_BYTES = BK * BN * 2;               // 16 KB at BN 128
  static constexpr int B_ATOMS = BN / 64;                   // an MN-major B tile's atoms
  static_assert(BM % 64 == 0 && BM <= 256 && (BN == 64 || BN == 128), "a compiled tile");

  // the deepest ring (at most MAX_STAGES) whose stages, with `extra` bytes
  // beside them, the 1024-byte alignment slack and two mbarriers a stage,
  // fit in SMEM_MAX
  static constexpr int stages_for(int stage, int extra) {
    const int n = (SMEM_MAX - 1024 - extra - 2 * MAX_STAGES * 8) / (A_BYTES + stage);
    return n < MAX_STAGES ? n : MAX_STAGES;
  }
};

// The compiled tiles (bm, bn): `f` called with the Tile, or
// cudaErrorInvalidValue for a tile outside the set. The first is the default.
template <class F>
int with_tile(int bm, int bn, F&& f) {
  if (bm == 256 && bn == 128) return f(Tile<256, 128>{});
  if (bm == 128 && bn == 128) return f(Tile<128, 128>{});
  if (bm == 128 && bn == 64) return f(Tile<128, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class BT>
constexpr size_t smem_bytes() {
  return 1024 + size_t(BT::STAGES) * (BT::T::A_BYTES + BT::STAGE) + BT::EXTRA +
         2 * BT::STAGES * sizeof(uint64_t);
}

// B is the weight w, read MN-major (forward) or K-major (dX), and the uint8
// mask tile (B's layout, unswizzled) comes by TMA beside it: the consumers
// multiply w by m in place, 16-byte chunks each.
template <bool MN, class TL>
struct MaskedB {
  using T = TL;
  struct Maps {
    CUtensorMap w, m;
  };
  static constexpr bool B_MN = MN, FORMS = true;
  static constexpr int M_BYTES = BK * TL::BN;  // the mask tile, 8 KB at BN 128
  static constexpr int TX = TL::B_BYTES + M_BYTES, STAGE = TX, EXTRA = 0;
  static constexpr int STAGES = TL::stages_for(STAGE, EXTRA);

  static __device__ __forceinline__ void load(uint8_t* sb, const Maps& maps, uint64_t* bar,
                                              int k0, int col0, int z) {
    if (MN) {  // BN / 64 atoms of [k][col], 64 columns wide
#pragma unroll
      for (int a = 0; a < TL::B_ATOMS; ++a)
        hp::tma_load_3d(sb + a * ATOM, &maps.w, bar, col0 + 64 * a, k0, z);
    } else {  // BN rows (output columns) of 64 k
      hp::tma_load_3d(sb, &maps.w, bar, k0, col0, z);
    }
    hp::tma_load_3d(sb + TL::B_BYTES, &maps.m, bar, MN ? col0 : k0, MN ? k0 : col0, z);
  }

  // w * m in place. The B tile: MN-major 64 rows k of BN columns in BN / 64
  // atoms, K-major BN rows (w's rows) of 64 k in one; chunk (r, e) of 8
  // values sits at its swizzled place in B and at r * ROW + e in the mask.
  static __device__ __forceinline__ const uint8_t* form(uint8_t* sb, uint8_t*, int, int tid) {
    constexpr int ROWS = MN ? BK : TL::BN, ROW = MN ? TL::BN : BK, ROW_CH = ROW / 8;
    static_assert(ROWS * ROW_CH % TL::CTHREADS == 0, "whole chunks a thread");
    const uint8_t* sm = sb + TL::B_BYTES;
#pragma unroll
    for (int i = 0; i < ROWS * ROW_CH / TL::CTHREADS; ++i) {
      const int c = tid + TL::CTHREADS * i, r = c / ROW_CH, e = (c % ROW_CH) * 8;
      uint4* wp = reinterpret_cast<uint4*>(sb + (e / 64) * (ROWS * 128) + r * 128 +
                                           ((((e % 64) / 8) ^ (r & 7)) << 4));
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
    return sb;
  }
};

// B read MN-major as it is (dW's dy): nothing to form.
template <class TL>
struct PlainB {
  using T = TL;
  struct Maps {
    CUtensorMap b;
  };
  static constexpr bool B_MN = true, FORMS = false;
  static constexpr int TX = TL::B_BYTES, STAGE = TX, EXTRA = 0;
  static constexpr int STAGES = TL::stages_for(STAGE, EXTRA);

  static __device__ __forceinline__ void load(uint8_t* sb, const Maps& maps, uint64_t* bar,
                                              int k0, int col0, int z) {
#pragma unroll
    for (int a = 0; a < TL::B_ATOMS; ++a)
      hp::tma_load_3d(sb + a * ATOM, &maps.b, bar, col0 + 64 * a, k0, z);
  }
};

template <bool A_MN, class BT, int EPI>
__global__ void __launch_bounds__(BT::T::THREADS, 1)
gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ typename BT::Maps maps_b,
     const void* __restrict__ ce, __nv_bfloat16* __restrict__ C, int Mc, int Kc, int Nc,
     long long ldce, long long ldc, long long ldce_z, long long ldc_z) {
  using TL = typename BT::T;
  constexpr int BM = TL::BM, BN = TL::BN, CONSUMERS = TL::CONSUMERS, CTHREADS = TL::CTHREADS;
  static_assert(BT::STAGES >= 2, "the ring needs two stages");
  constexpr int STAGES = BT::STAGES, STAGE = TL::A_BYTES + BT::STAGE;
  extern __shared__ uint8_t gm_smem_raw[];
  uint8_t* smem = gm_smem_raw + ((1024 - (hp::smem_u32(gm_smem_raw) & 1023)) & 1023);
  uint8_t* extra = smem + STAGES * STAGE;
  uint64_t* loaded = reinterpret_cast<uint64_t*>(extra + BT::EXTRA);
  uint64_t* empty = loaded + STAGES;
  const int tid = threadIdx.x, z = blockIdx.y;

  // output tile: groups of GROUP tile rows, walked column by column
  const int nM = (Mc + BM - 1) / BM, nN = (Nc + BN - 1) / BN;
  const int per_group = GROUP * nN, in_group = blockIdx.x % per_group;
  const int first_m = (blockIdx.x / per_group) * GROUP;
  const int gm_rows = min(nM - first_m, GROUP);
  const int row0 = (first_m + in_group % gm_rows) * BM, col0 = (in_group / gm_rows) * BN;
  const int nk = (Kc + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&loaded[s], 1);
      hp::mbar_init(&empty[s], 4 * CONSUMERS);  // one per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CTHREADS) {  // --------------------------------------- TMA warp ---
    if (tid == CTHREADS)
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        hp::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* sa = smem + s * STAGE;
        hp::mbar_expect_tx(&loaded[s], TL::A_BYTES + BT::TX);
        if (A_MN) {  // 64-wide atoms of [k][row]
          for (int a = 0; a < CONSUMERS; ++a)
            hp::tma_load_3d(sa + a * ATOM, &map_a, &loaded[s], row0 + 64 * a, k0, z);
        } else {  // BM rows of 64 k
          hp::tma_load_3d(sa, &map_a, &loaded[s], k0, row0, z);
        }
        BT::load(sa + TL::A_BYTES, maps_b, &loaded[s], k0, col0, z);
      }
  } else {  // ------------------------------------------------------ consumers ---
    const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      hp::mbar_wait(&loaded[s], (kt / STAGES) & 1);
      uint8_t* sa = smem + s * STAGE;
      const uint8_t* sb = sa + TL::A_BYTES;
      if constexpr (BT::FORMS) {  // while the previous stage's products run
        sb = BT::form(sa + TL::A_BYTES, extra, kt, tid);
        hp::fence_proxy_async();  // the stores, to wgmma's async proxy
        hp::named_sync(1, CTHREADS);
      }
      const uint8_t* swg = sa + wg * ATOM;  // this warpgroup's 64 rows of A
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = A_MN ? hp::desc(swg + kk * 16 * 128, 128, ATOM)
                                 : hp::desc(swg + kk * 32, 128, 0);
        const uint64_t db = BT::B_MN ? hp::desc(sb + kk * 16 * 128, 128, ATOM)
                                     : hp::desc(sb + kk * 32, 128, 0);
        hp::wgmma_ss<A_MN ? 1 : 0, BT::B_MN ? 1 : 0>(acc, da, db, 1);  // m64n{BN}k16
      }
      hp::wgmma_commit();
      // one group stays in flight: the previous stage's products are done
      hp::wgmma_wait<1>();
      __syncwarp();
      if (kt > 0 && lane == 0) hp::mbar_arrive(&empty[(kt + STAGES - 1) % STAGES]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    // acc[4j + 2h + e]: row 16 warp + g + 8h, column 8j + 2q + e
    const int g = lane / 4, q = lane % 4;
    C += z * ldc_z;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = col0 + 8 * j + 2 * q;
      if (gc >= Nc) continue;  // Nc % 8 == 0: a pair is wholly in or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wg * 64 + warp * 16 + g + 8 * h;
        if (gr >= Mc) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (EPI == EPI_MASK) {
          const uint8_t* mp = static_cast<const uint8_t*>(ce) + z * ldce_z + gr * ldce + gc;
          if (mp[0] == 0) v0 = 0.f;
          if (mp[1] == 0) v1 = 0.f;
        } else if constexpr (EPI == EPI_SCALE) {
          const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(ce) + z * ldce_z + gr * ldce + gc));
          v0 *= sc.x;
          v1 *= sc.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(C + gr * ldc + gc) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A (rows x cols) matrix with row stride ld (values) as a 2-D TMA map read
// in boxes of box_cols x box_rows, unswizzled (the threads read these
// tiles: nm_spmm's vals, whose 64-column box rows are 128 bytes, and idx);
// uint8 with `bytes`.
inline bool map2(CUtensorMap* map, const void* base, int rows, int cols, long long ld,
                 uint32_t box_cols, uint32_t box_rows, bool bytes = false) {
  const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
  const uint64_t stride[1] = {uint64_t(ld) * (bytes ? 1 : 2)};
  const uint32_t box[2] = {box_cols, box_rows};
  return hp::make_map(map, base, 2, dims, stride, box, bytes, true);
}

// `batch` slabs of a (rows x cols) matrix, row stride ld and slab stride
// ldz (values), as a rank-3 TMA map read in boxes of box_cols x box_rows of
// one slab; uint8 with `bytes`. One slab's stride is its own size.
inline bool map3(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                 long long ld, long long ldz, uint32_t box_cols, uint32_t box_rows,
                 bool bytes = false) {
  const uint64_t es = bytes ? 1 : 2;
  const uint64_t dims[3] = {uint64_t(cols), uint64_t(rows), uint64_t(batch)};
  const uint64_t stride[2] = {uint64_t(ld) * es, uint64_t(batch > 1 ? ldz : rows * ld) * es};
  const uint32_t box[3] = {box_cols, box_rows, 1};
  return hp::make_map(map, base, 3, dims, stride, box, bytes);
}

// The A operand: MN-major, (Kc rows, Mc cols) read in 64 x 64 boxes, or
// K-major, (Mc rows, Kc cols) read in bm-row boxes; `batch` slabs ldz apart.
inline bool map_a(CUtensorMap* map, const void* A, int Mc, int Kc, long long lda, bool mn,
                  int bm, int batch = 1, long long ldz = 0) {
  return mn ? map3(map, A, batch, Kc, Mc, lda, ldz, 64, 64)
            : map3(map, A, batch, Mc, Kc, lda, ldz, 64, bm);
}

template <bool A_MN, class BT, int EPI>
int launch(const CUtensorMap& map_a, const typename BT::Maps& maps_b, const void* ce, void* C,
           int Mc, int Kc, int Nc, long long ldce, long long ldc, void* stream, int batch = 1,
           long long ldce_z = 0, long long ldc_z = 0) {
  using TL = typename BT::T;
  auto kernel = gemm<A_MN, BT, EPI>;
  constexpr size_t smem = smem_bytes<BT>();
  static_assert(smem <= SMEM_MAX, "the ring does not fit in shared memory");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)((Mc + TL::BM - 1) / TL::BM) * ((Nc + TL::BN - 1) / TL::BN);
  kernel<<<dim3((unsigned)tiles, (unsigned)batch), TL::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(map_a, maps_b, ce,
                                                 static_cast<__nv_bfloat16*>(C), Mc, Kc, Nc,
                                                 ldce, ldc, ldce_z, ldc_z);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled kernel of policy BT takes (hp::query_kernel).
template <bool A_MN, class BT, int EPI>
int query(int* out) {
  return hp::query_kernel(gemm<A_MN, BT, EPI>, smem_bytes<BT>(), BT::T::THREADS, BT::STAGES, out);
}

}  // namespace gm
