// flash_attention: blocked online-softmax attention for Hopper (sm_90a),
// forward and backward.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`),
// which src/repro/kernels/flash_attention/ops.py::flash_attention_bshd
// reaches from the model's attention with attn_impl="flash". The JAX
// package has no backward kernel; the backward at the end of this file
// gives the gradient of this forward for EBFT's tuning steps.
//
// What bounds it on an H100: causal attention at the slice's shape
// (BH = 256, S = 2048, d = 128) does about 4*S*d/2 = 0.5 M operations per
// (q, k, v, o) row of 4 x 256 bytes in bf16, far above the ~295
// operations per byte where the card stops waiting on HBM: it is bound by
// operations, and the S x S scores must never reach device memory.
//
// Design: one thread block handles one (bh, query tile) and loops over key
// tiles with the online-softmax recurrence; the TPU kernel's sequential key
// grid axis and its VMEM scratch (m, l, acc) become that loop, shared
// memory and registers. Semantics follow the TPU kernel:
//   * q and k are upcast to f32 and the scores are f32 products;
//   * causal masking is shifted by q_offset; key tiles wholly above the
//     diagonal are never visited, and only tiles that cross it are masked,
//     with -1e30 as in the reference;
//   * p is rounded to v's dtype before the PV product, while the
//     normaliser sums the unrounded p; m, l and acc stay f32;
//   * the normaliser is clamped at 1e-30.
// Keys past the end of a ragged last tile contribute exactly zero.
// Two kernels share these semantics:
//   * bf16 (flash_fwd_tc): 128-row query tiles, two consumer warpgroups and
//     a TMA warp; both products on wgmma, K and V streamed by TMA through
//     a ring, P kept in registers (see the kernel); it takes 16-byte-aligned
//     operands only and refuses others with cudaErrorInvalidValue;
//   * f32 (no TF32: IEEE products for the 2e-5 tolerance): SIMT fp32 FMAs,
//     64-row query and 32-key tiles.
// With a non-null `lse` either forward also writes the f32 row
// log-sum-exp of the scaled, masked scores, m + log(max(l, 1e-30)), which
// the backward reads; the no-grad callers pass null and write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BKV = 32, THREADS = 128;
constexpr float NEG = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1) + BQ);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int Sq, int Sk, int causal, int q_offset, float scale) {
  static_assert(HD % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int QLD = HD + 1, PLD = BKV + 1, NJ = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x QLD
  float* Ks = Qs + BQ * QLD;      // BKV x QLD
  float* Vs = Ks + BKV * QLD;     // BKV x HD
  float* Ps = Vs + BKV * HD;      // BQ x PLD: scores, then rounded p
  float* rowv = Ps + BQ * PLD;    // BQ: per-row rescale, then the normaliser

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // 8 x 16: rows ty*4+i, cols tx+8j
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * Sq * HD;
  const float* kb = k + bh * Sk * HD;
  const float* vb = v + bh * Sk * HD;
  float* ob = o + bh * Sq * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    Qs[r * QLD + c] = (q0 + r < Sq) ? qb[(long long)(q0 + r) * HD + c] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  // softmax statistics: thread pair (2r, 2r+1) owns query row r
  const int srow = tid >> 1, shalf = tid & 1;
  float m_row = NEG, l_row = 0.f;

  const int q_pos0 = q_offset + q0;
  int n_kt = (Sk + BKV - 1) / BKV;
  if (causal) n_kt = min(n_kt, (q_pos0 + BQ - 1) / BKV + 1);  // skip tiles above

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's Vs/Ps reads are done
    for (int e = tid; e < BKV * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < Sk;
      const long long g = (long long)(k0 + r) * HD + c;
      Ks[r * QLD + c] = in ? kb[g] : 0.f;
      Vs[r * HD + c] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 8 * j) * QLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    const bool diag = causal && (q_pos0 < k0 + BKV - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        float val = s[i][j] * scale;
        if (diag && q_pos0 + r < k0 + c) val = NEG;
        if (k0 + c >= Sk) val = -INFINITY;  // past the end: p == 0 exactly
        Ps[r * PLD + c] = val;
      }
    }
    __syncthreads();

    {
      float* prow = Ps + srow * PLD + shalf * (BKV / 2);
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < BKV / 2; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_row, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 2; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = p;  // p in v's dtype (f32) for PV
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_row - m_new);
      l_row = l_row * corr + sum;
      m_row = m_new;
      if (shalf == 0) rowv[srow] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = rowv[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * HD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (shalf == 0) {
    rowv[srow] = fmaxf(l_row, 1e-30f);
    if (lse != nullptr && q0 + srow < Sq) lse[bh * Sq + q0 + srow] = m_row + logf(rowv[srow]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = rowv[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[(long long)(q0 + r) * HD + tx + 8 * j] = acc[i][j] / l;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
           int Sq, int Sk, int causal, int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, causal, q_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- bf16 on wgmma ---
// Tiles of the bf16 kernels (forward and backward), every product a wgmma
// m64nNk16 with f32 accumulators. A tile of ROWS rows of a (BH, S, d)
// tensor is stored in the TMA swizzle of a 2*min(d, 64)-byte row
// (hopper.cuh): atom a holds its d values a*64 .. a*64 + 63 of every row.
// It is read K-major (rows = the operand's M or N, reduction along d) or
// MN-major (reduction along the rows, N = d). Rows past S arrive as zeros.
template <int HD, int ROWS = 64>
struct TcTile {
  static constexpr int EPR = HD < 64 ? HD : 64;  // values in a row of an atom
  static constexpr int W = 2 * EPR;              // its bytes: 128, 64 or 32
  static constexpr int ATOMS = HD / EPR;
  static constexpr int BYTES = ROWS * HD * 2;    // a 1024-byte multiple
  static constexpr int ATOM = ROWS * W;
  static_assert(ROWS % 64 == 0, "tiles load in 64-row boxes");
  // operand rows = tile rows, reduction along d: step kk of 16 values
  static __device__ __forceinline__ uint64_t kmajor(const uint8_t* t, int kk) {
    return hp::desc(t + (kk * 16 / EPR) * ATOM + (kk * 16 % EPR) * 2, W, 0);
  }
  // reduction along the tile rows, N = d: step kk of 16 rows
  static __device__ __forceinline__ uint64_t mnmajor(const uint8_t* t, int kk) {
    return hp::desc(t + kk * 16 * W, W, ATOM);
  }
  // rows [row0, row0 + ROWS) of head bh of a (BH, S, d) map, in 64-row boxes
  static __device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row0, int bh) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int r = 0; r < ROWS; r += 64)
        hp::tma_load_3d(dst + a * ATOM + r * W, map, bar, a * EPR, row0 + r, bh);
  }
};

// two values -> one register, the first in the low half (lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an m64nN accumulator (R = N / 2 values a thread) -> the bf16 A operands
// of its N / 16 steps of 16 (hopper.cuh: the accumulator layout is the
// register A layout)
template <int R>
__device__ __forceinline__ void to_a_operand(const float (&d)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int c = 0; c < R / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[c][r] = pack2(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);
}

// a (BH, S, d) bf16 tensor as a TMA map read in 64-row boxes
template <int HD>
bool head_map(CUtensorMap* map, const void* base, int BH, int S) {
  const uint64_t dims[3] = {HD, uint64_t(S), uint64_t(BH)};
  const uint64_t strides[2] = {HD * 2, uint64_t(S) * HD * 2};
  const uint32_t box[3] = {TcTile<HD>::EPR, 64, 1};
  return hp::make_map(map, base, 3, dims, strides, box);
}

// The bf16 forward. One block per (bh, 128-row query tile); two consumer
// warpgroups take 64 query rows each and one more warp issues the TMA
// loads. Q is loaded once; K and V stream in FW_BKV-key tiles through a
// ring of FW_STAGES stages (mbarriers `full`, `empty`): the producer asks
// for the tile FW_STAGES ahead as soon as both warpgroups have freed a
// stage. 128-key tiles and 3 stages ran faster than 64-key tiles or 2
// stages; a software pipeline that issued the next tile's S beside this
// tile's PV (with registers moved to the consumers by setmaxnreg) ran
// slower (PERF.md).
// Per key tile a warpgroup computes
//     S = Q K^T      wgmma SS m64n{FW_BKV}k16, both operands K-major;
// then the online softmax in registers on the accumulator layout, and
//     O += P V       wgmma RS m64n{d}k16: P rounded to bf16 in place into
//                    the register A operand, V read MN-major from its tile,
// so P never touches shared memory. The reference's semantics stay: f32
// scores scaled by 1/sqrt(d); key tiles wholly above a warpgroup's shifted
// diagonal are skipped and only tiles crossing it are masked, with -1e30;
// keys past Sk give p == 0 exactly (their score is -inf); the normaliser
// sums the unrounded p; m, l and O stay f32; l is clamped at 1e-30, and
// with non-null `lse` the kernel writes m + log(max(l, 1e-30)). The
// exponentials are exp2f of the score times log2(e) less m times log2(e)
// (one FMA), not expf of the difference: the same value up to the rounding
// of that argument. The blocks of one head run side by side, so its K and
// V come from HBM once and from L2 for its other query tiles (with the
// head as the fastest grid index, the 132 blocks on the card read 132
// heads' K and V: about 2.3 GB from HBM at (256, 2048, 128)); within a
// head the longest query tiles (under a causal mask) go first.
constexpr int FW_BQ = 128, FW_BKV = 128, FW_STAGES = 3;
constexpr int FW_CONSUMERS = FW_BQ / 64, FW_CTHREADS = 128 * FW_CONSUMERS;
constexpr int FW_THREADS = FW_CTHREADS + 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t fw_smem() {  // Q, the ring of K and V tiles, barriers
  return 1024 + FW_CONSUMERS * TcTile<HD>::BYTES + 2 * FW_STAGES * TcTile<HD, FW_BKV>::BYTES +
         (2 * FW_STAGES + 1) * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int causal, int q_offset, float scale) {
  using QT = TcTile<HD>;          // a warpgroup's 64 query rows
  using KT = TcTile<HD, FW_BKV>;  // a key tile, or a value tile
  extern __shared__ uint8_t t_smem_raw[];
  uint8_t* sm = t_smem_raw + ((1024 - (hp::smem_u32(t_smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;                                // warpgroup w's rows at w * QT::BYTES
  uint8_t* stage = Qs + FW_CONSUMERS * QT::BYTES;  // stage s: K at 2s KT::BYTES, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 2 * FW_STAGES * KT::BYTES);
  uint64_t* empty = full + FW_STAGES;
  uint64_t* qbar = empty + FW_STAGES;

  // a head's query tiles run side by side (they share its K and V in L2),
  // the longest (causal) first
  const int tid = threadIdx.x, bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BQ;
  int ntiles = (Sk + FW_BKV - 1) / FW_BKV;
  if (causal) ntiles = min(ntiles, (q_offset + q0 + FW_BQ - 1) / FW_BKV + 1);  // skip tiles above

  if (tid == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4 * FW_CONSUMERS);  // one per consumer warp
    }
    hp::mbar_init(qbar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= FW_CTHREADS) {  // ------------------------------------ TMA warp ---
    if (tid == FW_CTHREADS) {
      hp::mbar_expect_tx(qbar, FW_CONSUMERS * QT::BYTES);
      for (int w = 0; w < FW_CONSUMERS; ++w)
        QT::load(Qs + w * QT::BYTES, &map_q, qbar, q0 + 64 * w, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % FW_STAGES;
        hp::mbar_wait(&empty[s], ((it / FW_STAGES) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], 2 * KT::BYTES);
        KT::load(stage + 2 * s * KT::BYTES, &map_k, &full[s], it * FW_BKV, bh);
        KT::load(stage + (2 * s + 1) * KT::BYTES, &map_v, &full[s], it * FW_BKV, bh);
      }
    }
    return;
  }
  // ----------------------------------------------------------------- consumers ---
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32, g = lane / 4, q4 = lane % 4;
  const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
  int my_tiles = ntiles;         // the key tiles not wholly above its diagonal
  if (causal) my_tiles = min(ntiles, (q_offset + qw0 + 63) / FW_BKV + 1);
  const uint8_t* Qw = Qs + wg * QT::BYTES;
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};  // rows 16 warp + g + 8h
  hp::mbar_wait(qbar, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % FW_STAGES, k0 = it * FW_BKV;
    // also for a skipped tile: no copy outlives the block
    hp::mbar_wait(&full[s], (it / FW_STAGES) & 1);
    if (it < my_tiles) {
      const uint8_t* Ks = stage + 2 * s * KT::BYTES;
      const uint8_t* Vs = Ks + KT::BYTES;
      float sa[FW_BKV / 2];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hp::wgmma_ss<0, 0>(sa, QT::kmajor(Qw, kk), KT::kmajor(Ks, kk), kk);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(sa);
      // sa[i]: query row 16 warp + g + 8 ((i / 2) % 2), key 8 (i / 4) + 2 q4 + i % 2
      const bool edge = (causal && q_offset + qw0 < k0 + FW_BKV - 1) || k0 + FW_BKV > Sk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < FW_BKV / 2; ++i) {
        const int h = (i >> 1) & 1;
        float val = sa[i] * scale;
        if (edge) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * q4 + (i & 1);
          const int qpos = q_offset + qw0 + warp * 16 + g + 8 * h;
          if (causal && qpos < kpos) val = NEG;
          if (kpos >= Sk) val = -INFINITY;  // past the end: p == 0 exactly
        }
        sa[i] = val;
        mx[h] = fmaxf(mx[h], val);
      }
      float mb[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        corr[h] = exp2f((m_r[h] - m_new) * LOG2E);
        mb[h] = m_new * LOG2E;
        m_r[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < FW_BKV / 2; ++i) {
        const int h = (i >> 1) & 1;
        const float p = exp2f(fmaf(sa[i], LOG2E, -mb[h]));
        sa[i] = p;
        sum[h] += p;  // the normaliser sums the unrounded p
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_r[h] = l_r[h] * corr[h] + sum[h];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
      uint32_t pa[FW_BKV / 16][4];  // p rounded to bf16 (v's dtype), the A operand of PV
      to_a_operand(sa, pa);
      hp::wgmma_fence();
#pragma unroll
      for (int c = 0; c < FW_BKV / 16; ++c) hp::wgmma_rs(oacc, pa[c], KT::mnmajor(Vs, c), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(oacc);
#pragma unroll
      for (int c = 0; c < FW_BKV / 16; ++c) hp::fence_regs(pa[c]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
  // oacc[4j + 2h + e]: row 16 warp + g + 8h, column 8j + 2 q4 + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw0 + warp * 16 + g + 8 * h;
    if (r >= Sq) continue;
    const float l = fmaxf(l_r[h], 1e-30f);
    if (lse != nullptr && q4 == 0) lse[(long long)bh * Sq + r] = m_r[h] + logf(l);
    const long long base = ((long long)bh * Sq + r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + base + 8 * j + 2 * q4) =
          pack2(oacc[4 * j + 2 * h] / l, oacc[4 * j + 2 * h + 1] / l);
  }
}

template <int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                  int Sq, int Sk, int causal, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!(head_map<HD>(&mq, q, BH, Sq) && head_map<HD>(&mk, k, BH, Sk) &&
        head_map<HD>(&mv, v, BH, Sk)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = fw_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + FW_BQ - 1) / FW_BQ, BH);
  flash_fwd_tc<HD><<<grid, FW_THREADS, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                                      lse, Sq, Sk, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward ---
// dQ, dK, dV of the forward above from its output o, the upstream gradient
// dO and the f32 row log-sum-exp of the scaled, masked scores (written by
// the forward when the caller asks), with P = exp(s - lse) and
//     D  = rowsum(dO * O)
//     dV = P^T dO,   dS = P * (dO V^T - D),   dQ = scale dS K,   dK = scale dS^T Q.
// The forward rounds p to v's dtype before PV; its gradient passes that
// cast straight through, as JAX's astype does, so the formula takes the
// unrounded P. The f32 kernels below compute it and dS in f32 throughout;
// the bf16 kernels (after them) round P and dS to bf16 where they become
// the A operand of the second products.
// What bounds it on an H100: five products of 2*d operations per
// unmasked (query, key) pair against 8 rows of d values of I/O per row,
// so, as the forward, it is bound by operations.
// Three kernels, no atomics, so the result does not depend on the order
// blocks run in: a warp per row for D; one block per key tile that walks
// the query tiles at or below the shifted diagonal and keeps its dK and dV
// rows in registers; one block per query tile that walks the key tiles up
// to the diagonal for dQ (it recomputes P and dS). The f32 kernels use
// 32 x 32 tiles and IEEE f32 FMAs on the SIMT units (no TF32, for the 2e-5
// tolerance); the bf16 kernels use 64 x 64 tiles and wgmma.
constexpr int B_Q = 32, B_K = 32, B_THREADS = 256;

template <typename T>
__device__ __forceinline__ float to_f(T x) { return static_cast<float>(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x) { return static_cast<T>(x); }

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * B_Q * (HD + 1) + 2 * B_K * (HD + 1) + 2 * B_Q * (B_K + 1) + 2 * B_Q);
}

template <typename T>
__global__ void __launch_bounds__(B_THREADS)
bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ D,
                  long long rows, int HD) {
  const long long row = blockIdx.x * (long long)(B_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) acc = fmaf(to_f(dO[row * HD + c]), to_f(o[row * HD + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// rows [row0, row0 + rows) of a (S, HD) matrix into f32 shared memory with
// row stride HD + 1, zero past `limit`
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int limit, int rows) {
  for (int e = threadIdx.x; e < rows * HD; e += B_THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = (row0 + r < limit) ? to_f(src[(long long)(row0 + r) * HD + c]) : 0.f;
  }
}

// P and dS of one (32 query x 32 key) tile into Ps and dSs. Thread t takes
// query row t / 8 and keys t % 8 + 8j. Scores are scaled and masked as the
// forward's, then P = exp(s - lse); rows past Sq and keys past Sk get 0.
template <int HD>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse_s,
                                          const float* D_s, float* Ps, float* dSs, int q0,
                                          int k0, int Sq, int Sk, int causal, int q_offset,
                                          float scale) {
  constexpr int LD = HD + 1, PLD = B_K + 1;
  const int r = threadIdx.x / 8, cx = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float a = Qs[r * LD + d], g = dOs[r * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = fmaf(a, Ks[(cx + 8 * j) * LD + d], s[j]);
      dp[j] = fmaf(g, Vs[(cx + 8 * j) * LD + d], dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = cx + 8 * j;
    float val = s[j] * scale;
    if (causal && q_offset + q0 + r < k0 + c) val = NEG;
    float p = expf(val - lse_s[r]);
    if (q0 + r >= Sq || k0 + c >= Sk) p = 0.f;
    Ps[r * PLD + c] = p;
    dSs[r * PLD + c] = p * (dp[j] - D_s[r]);
  }
}

// the tile's rows of lse and D into shared memory (0 past Sq)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* D_s, const float* lse,
                                               const float* D, long long base, int q0, int Sq) {
  if (threadIdx.x < B_Q) {
    const bool in = q0 + threadIdx.x < Sq;
    lse_s[threadIdx.x] = in ? lse[base + q0 + threadIdx.x] : 0.f;
    D_s[threadIdx.x] = in ? D[base + q0 + threadIdx.x] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(B_THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                int Sk, int causal, int q_offset, float scale) {
  constexpr int LD = HD + 1, PLD = B_K + 1, NJ = HD / 8;
  extern __shared__ float bsm[];
  float* Qs = bsm;
  float* dOs = Qs + B_Q * LD;
  float* Ks = dOs + B_Q * LD;
  float* Vs = Ks + B_K * LD;
  float* Ps = Vs + B_K * LD;
  float* dSs = Ps + B_Q * PLD;
  float* lse_s = dSs + B_Q * PLD;
  float* D_s = lse_s + B_Q;

  const int k0 = blockIdx.x * B_K;
  const long long bh = blockIdx.y;
  load_rows<T, HD>(Ks, k + bh * Sk * HD, k0, Sk, B_K);
  load_rows<T, HD>(Vs, v + bh * Sk * HD, k0, Sk, B_K);
  // thread t owns key row c = t / 8, columns t % 8 + 8j of dK and dV
  const int c = threadIdx.x / 8, cx = threadIdx.x % 8;
  float dk_acc[NJ], dv_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int n_qt = (Sq + B_Q - 1) / B_Q;
  // the first query tile holding a row at or below the diagonal for key k0
  const int qt0 = causal ? max(0, k0 - q_offset) / B_Q : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * B_Q;
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, HD>(Qs, q + bh * Sq * HD, q0, Sq, B_Q);
    load_rows<T, HD>(dOs, dO + bh * Sq * HD, q0, Sq, B_Q);
    load_row_stats(lse_s, D_s, lse, D, bh * Sq, q0, Sq);
    __syncthreads();
    p_ds_tile<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0, Sq, Sk, causal, q_offset, scale);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < B_Q; ++r) {
      const float p = Ps[r * PLD + c], ds = dSs[r * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dv_acc[j] = fmaf(p, dOs[r * LD + cx + 8 * j], dv_acc[j]);
        dk_acc[j] = fmaf(ds, Qs[r * LD + cx + 8 * j], dk_acc[j]);
      }
    }
  }
  if (k0 + c < Sk) {
    const long long base = (bh * Sk + k0 + c) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[base + cx + 8 * j] = from_f<T>(dk_acc[j] * scale);
      dv[base + cx + 8 * j] = from_f<T>(dv_acc[j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(B_THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dO, const float* __restrict__ lse,
              const float* __restrict__ D, T* __restrict__ dq, int Sq, int Sk, int causal,
              int q_offset, float scale) {
  constexpr int LD = HD + 1, PLD = B_K + 1, NJ = HD / 8;
  extern __shared__ float bsm[];
  float* Qs = bsm;
  float* dOs = Qs + B_Q * LD;
  float* Ks = dOs + B_Q * LD;
  float* Vs = Ks + B_K * LD;
  float* Ps = Vs + B_K * LD;
  float* dSs = Ps + B_Q * PLD;
  float* lse_s = dSs + B_Q * PLD;
  float* D_s = lse_s + B_Q;

  const int q0 = blockIdx.x * B_Q;
  const long long bh = blockIdx.y;
  load_rows<T, HD>(Qs, q + bh * Sq * HD, q0, Sq, B_Q);
  load_rows<T, HD>(dOs, dO + bh * Sq * HD, q0, Sq, B_Q);
  load_row_stats(lse_s, D_s, lse, D, bh * Sq, q0, Sq);
  // thread t owns query row r = t / 8, columns t % 8 + 8j of dQ
  const int r = threadIdx.x / 8, cx = threadIdx.x % 8;
  float dq_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq_acc[j] = 0.f;

  int n_kt = (Sk + B_K - 1) / B_K;
  if (causal) n_kt = min(n_kt, (q_offset + q0 + B_Q - 1) / B_K + 1);  // skip tiles above
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * B_K;
    __syncthreads();
    load_rows<T, HD>(Ks, k + bh * Sk * HD, k0, Sk, B_K);
    load_rows<T, HD>(Vs, v + bh * Sk * HD, k0, Sk, B_K);
    __syncthreads();
    p_ds_tile<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0, Sq, Sk, causal, q_offset, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < B_K; ++c) {
      const float ds = dSs[r * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) dq_acc[j] = fmaf(ds, Ks[c * LD + cx + 8 * j], dq_acc[j]);
    }
  }
  if (q0 + r < Sq) {
    const long long base = (bh * Sq + q0 + r) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[base + cx + 8 * j] = from_f<T>(dq_acc[j] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dO,
               const float* lse, float* D, void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dO_ = static_cast<const T*>(dO);
  const long long rows = (long long)BH * Sq;
  bwd_rowdot_kernel<T><<<(unsigned)((rows + B_THREADS / 32 - 1) / (B_THREADS / 32)), B_THREADS,
                         0, stream>>>(static_cast<const T*>(o), dO_, D, rows, HD);
  bwd_dkdv_kernel<T, HD><<<dim3((Sk + B_K - 1) / B_K, BH), B_THREADS, smem, stream>>>(
      q_, k_, v_, dO_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, causal,
      q_offset, scale);
  bwd_dq_kernel<T, HD><<<dim3((Sq + B_Q - 1) / B_Q, BH), B_THREADS, smem, stream>>>(
      q_, k_, v_, dO_, lse, D, static_cast<T*>(dq), Sq, Sk, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dispatch(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 const void* lse, void* D, void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
                 int d, int causal, int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* Db = static_cast<float*>(D);
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ------------------------------------------- backward, bf16 on wgmma ---
// The same function on the tensor cores, transposed where that keeps P and
// dS in registers. Every product is a wgmma m64nNk16 with f32 accumulators:
//   dK/dV kernel, one block (one warpgroup) per 64-key tile, walking the
//   64-row query tiles at or below the shifted diagonal:
//     S^T  = K Q^T   and  dP^T = V dO^T   (SS: K, V resident; Q, dO
//                                          streamed; all K-major, N = 64)
//     P^T, dS^T in registers, rounded to bf16 pairs, become the A operand of
//     dV  += P^T dO  and  dK  += dS^T Q   (RS: dO, Q read MN-major, N = d);
//   dQ kernel, one block per 64-row query tile, walking the key tiles up to
//     the diagonal:
//     S = Q K^T, dP = dO V^T (SS), then dQ += dS K (RS: K read MN-major).
// P and dS are rounded to bf16 before the second products (as the forward
// rounds p before PV); S, dP and every sum stay f32, and the plain version
// (flash_attention_bwd_plain) stays f32 as the oracle. The dQ kernel
// recomputes S and dP, so a pair costs 7 products of 2*d operations
// instead of 5: the price of writing dQ without atomics, so that the result
// does not depend on the order blocks run in and a repeat gives the same
// bits. No product goes through the SIMT units or shared memory stores.
// The streamed tiles (Q and dO, or K and V) arrive by TMA into a ring of
// two stages: the tile after next is requested as soon as every thread is
// done with a stage, so it lands while the next one is multiplied; two
// blocks share an SM and cover each other's elementwise phases. Tiles are
// stored in the TMA swizzle of a 2*min(d, 64)-byte row (hopper.cuh); rows
// past Sq or Sk are filled with zeros, and P is set to 0 there. Operands
// must be 16-byte aligned (the TMA's rule; (BH, S, d) tensors of any S then
// have 16-byte strides).
constexpr int T_BQ = 64, T_BK = 64, T_THREADS = 128;

template <int HD>
constexpr size_t tc_bwd_smem() {  // 2 resident + 2 stages x 2 streamed tiles, stats, barriers
  return 1024 + 6 * TcTile<HD>::BYTES + 2 * T_BQ * sizeof(float) + 4 * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(T_THREADS, 2)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
            const float* __restrict__ lse, const float* __restrict__ D,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
            int causal, int q_offset, float scale) {
  using T = TcTile<HD>;
  extern __shared__ uint8_t t_smem_raw[];
  uint8_t* sm = t_smem_raw + ((1024 - (hp::smem_u32(t_smem_raw) & 1023)) & 1023);
  uint8_t* Ks = sm;
  uint8_t* Vs = Ks + T::BYTES;
  uint8_t* stage = Vs + T::BYTES;  // stage s: Q at stage + 2s BYTES, dO after it
  float* lse_s = reinterpret_cast<float*>(stage + 4 * T::BYTES);  // lse * log2(e)
  float* D_s = lse_s + T_BQ;
  uint64_t* bar = reinterpret_cast<uint64_t*>(D_s + T_BQ);  // resident, full[0], full[1]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, q4 = lane % 4;
  const int k0 = blockIdx.x * T_BK, bh = blockIdx.y;
  const int qt0 = causal ? max(0, k0 - q_offset) / T_BQ : 0;
  const int ntiles = max(0, (Sq + T_BQ - 1) / T_BQ - qt0);
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hp::mbar_init(&bar[i], 1);
    hp::mbar_fence_init();
    hp::mbar_expect_tx(&bar[0], 2 * T::BYTES);
    T::load(Ks, &map_k, &bar[0], k0, bh);
    T::load(Vs, &map_v, &bar[0], k0, bh);
    for (int i = 0; i < 2 && i < ntiles; ++i) {
      hp::mbar_expect_tx(&bar[1 + i], 2 * T::BYTES);
      T::load(stage + 2 * i * T::BYTES, &map_q, &bar[1 + i], (qt0 + i) * T_BQ, bh);
      T::load(stage + (2 * i + 1) * T::BYTES, &map_do, &bar[1 + i], (qt0 + i) * T_BQ, bh);
    }
  }
  __syncthreads();

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  hp::mbar_wait(&bar[0], 0);  // also when no tile is visited: no copy outlives the block

  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1, q0 = (qt0 + it) * T_BQ;
    const uint8_t* Qs = stage + 2 * s * T::BYTES;
    const uint8_t* dOs = Qs + T::BYTES;
    hp::mbar_wait(&bar[1 + s], (it >> 1) & 1);
    float st[32], dpt[32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss<0, 0>(st, T::kmajor(Ks, kk), T::kmajor(Qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss<0, 0>(dpt, T::kmajor(Vs, kk), T::kmajor(dOs, kk), kk);
    hp::wgmma_commit();
    {  // the query tile's statistics, while the products run
      const int r = tid % T_BQ;
      const bool in = q0 + r < Sq;
      const long long gq = (long long)bh * Sq + q0 + r;
      if (tid < T_BQ) lse_s[r] = in ? lse[gq] * LOG2E : 0.f;
      else D_s[r] = in ? D[gq] : 0.f;
    }
    __syncthreads();
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dpt);
    // st[i]: key row 16 warp + g + 8 ((i / 2) % 2), query column 8 (i / 4) + 2 q4 + i % 2
    const bool edge = (causal && q_offset + q0 < k0 + T_BK - 1) || q0 + T_BQ > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kr = warp * 16 + g + 8 * ((i >> 1) & 1), qc = 8 * (i >> 2) + 2 * q4 + (i & 1);
      float p = exp2f(st[i] * scale_log2 - lse_s[qc]);
      if (edge && ((causal && q_offset + q0 + qc < k0 + kr) || q0 + qc >= Sq)) p = 0.f;
      dpt[i] = p * (dpt[i] - D_s[qc]);
      st[i] = p;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_operand(st, pa);
    to_a_operand(dpt, dsa);
    hp::wgmma_fence();
#pragma unroll
    for (int c = 0; c < T_BQ / 16; ++c) {
      hp::wgmma_rs(dv_acc, pa[c], T::mnmajor(dOs, c), 1);
      hp::wgmma_rs(dk_acc, dsa[c], T::mnmajor(Qs, c), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hp::fence_regs(pa[c]);
      hp::fence_regs(dsa[c]);
    }
    __syncthreads();  // stage s and the statistics are free
    if (tid == 0 && it + 2 < ntiles) {
      hp::mbar_expect_tx(&bar[1 + s], 2 * T::BYTES);
      T::load(stage + 2 * s * T::BYTES, &map_q, &bar[1 + s], q0 + 2 * T_BQ, bh);
      T::load(stage + (2 * s + 1) * T::BYTES, &map_do, &bar[1 + s], q0 + 2 * T_BQ, bh);
    }
  }
  // dk_acc[4j + 2h + e]: key row 16 warp + g + 8h, column 8j + 2 q4 + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + warp * 16 + g + 8 * h;
    if (r >= Sk) continue;
    const long long base = ((long long)bh * Sk + r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * q4;
      *reinterpret_cast<uint32_t*>(dk + base + c) =
          pack2(dk_acc[4 * j + 2 * h] * scale, dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + c) =
          pack2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(T_THREADS, 2)
bwd_dq_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const float* __restrict__ lse, const float* __restrict__ D,
          __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int causal, int q_offset, float scale) {
  using T = TcTile<HD>;
  extern __shared__ uint8_t t_smem_raw[];
  uint8_t* sm = t_smem_raw + ((1024 - (hp::smem_u32(t_smem_raw) & 1023)) & 1023);
  uint8_t* Qs = sm;
  uint8_t* dOs = Qs + T::BYTES;
  uint8_t* stage = dOs + T::BYTES;  // stage s: K at stage + 2s BYTES, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 4 * T::BYTES + 2 * T_BQ * sizeof(float));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, q4 = lane % 4;
  const int q0 = blockIdx.x * T_BQ, bh = blockIdx.y;
  int ntiles = (Sk + T_BK - 1) / T_BK;
  if (causal) ntiles = min(ntiles, (q_offset + q0 + T_BQ - 1) / T_BK + 1);  // skip tiles above
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hp::mbar_init(&bar[i], 1);
    hp::mbar_fence_init();
    hp::mbar_expect_tx(&bar[0], 2 * T::BYTES);
    T::load(Qs, &map_q, &bar[0], q0, bh);
    T::load(dOs, &map_do, &bar[0], q0, bh);
    for (int i = 0; i < 2 && i < ntiles; ++i) {
      hp::mbar_expect_tx(&bar[1 + i], 2 * T::BYTES);
      T::load(stage + 2 * i * T::BYTES, &map_k, &bar[1 + i], i * T_BK, bh);
      T::load(stage + (2 * i + 1) * T::BYTES, &map_v, &bar[1 + i], i * T_BK, bh);
    }
  }
  __syncthreads();

  // this thread's query rows 16 warp + g + 8h: log2-scaled lse and D
  float lse2[2], Dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    const long long gq = (long long)bh * Sq + r;
    lse2[h] = r < Sq ? lse[gq] * LOG2E : 0.f;
    Dr[h] = r < Sq ? D[gq] : 0.f;
  }
  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  hp::mbar_wait(&bar[0], 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1, k0 = it * T_BK;
    const uint8_t* Ks = stage + 2 * s * T::BYTES;
    const uint8_t* Vs = Ks + T::BYTES;
    hp::mbar_wait(&bar[1 + s], (it >> 1) & 1);
    float sa[32], dp[32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss<0, 0>(sa, T::kmajor(Qs, kk), T::kmajor(Ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hp::wgmma_ss<0, 0>(dp, T::kmajor(dOs, kk), T::kmajor(Vs, kk), kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sa);
    hp::fence_regs(dp);
    // sa[i]: query row 16 warp + g + 8 ((i / 2) % 2), key column 8 (i / 4) + 2 q4 + i % 2
    const bool edge = (causal && q_offset + q0 < k0 + T_BK - 1) || k0 + T_BK > Sk ||
                      q0 + T_BQ > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, qr = warp * 16 + g + 8 * h;
      const int kc = 8 * (i >> 2) + 2 * q4 + (i & 1);
      float p = exp2f(sa[i] * scale_log2 - lse2[h]);
      if (edge && ((causal && q_offset + q0 + qr < k0 + kc) || k0 + kc >= Sk || q0 + qr >= Sq))
        p = 0.f;
      dp[i] = p * (dp[i] - Dr[h]);
    }
    uint32_t dsa[4][4];
    to_a_operand(dp, dsa);
    hp::wgmma_fence();
#pragma unroll
    for (int c = 0; c < T_BK / 16; ++c) hp::wgmma_rs(dq_acc, dsa[c], T::mnmajor(Ks, c), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq_acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) hp::fence_regs(dsa[c]);
    __syncthreads();  // stage s is free
    if (tid == 0 && it + 2 < ntiles) {
      hp::mbar_expect_tx(&bar[1 + s], 2 * T::BYTES);
      T::load(stage + 2 * s * T::BYTES, &map_k, &bar[1 + s], k0 + 2 * T_BK, bh);
      T::load(stage + (2 * s + 1) * T::BYTES, &map_v, &bar[1 + s], k0 + 2 * T_BK, bh);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    if (r >= Sq) continue;
    const long long base = ((long long)bh * Sq + r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + base + 8 * j + 2 * q4) =
          pack2(dq_acc[4 * j + 2 * h] * scale, dq_acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int HD>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o, const void* dO,
                  const float* lse, float* D, void* dq, void* dk, void* dv, int BH, int Sq,
                  int Sk, int causal, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!(head_map<HD>(&mq, q, BH, Sq) && head_map<HD>(&mk, k, BH, Sk) &&
        head_map<HD>(&mv, v, BH, Sk) && head_map<HD>(&mdo, dO, BH, Sq)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = tc_bwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(bwd_dkdv_tc<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const long long rows = (long long)BH * Sq;
  bwd_rowdot_kernel<bf><<<(unsigned)((rows + B_THREADS / 32 - 1) / (B_THREADS / 32)), B_THREADS,
                          0, stream>>>(static_cast<const bf*>(o), static_cast<const bf*>(dO), D,
                                       rows, HD);
  bwd_dkdv_tc<HD><<<dim3((Sk + T_BK - 1) / T_BK, BH), T_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, lse, D, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, causal,
      q_offset, scale);
  bwd_dq_tc<HD><<<dim3((Sq + T_BQ - 1) / T_BQ, BH), T_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, lse, D, static_cast<bf*>(dq), Sq, Sk, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse (BH, Sq) f32 receives the row log-sum-exp when it is not null
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int BH, int Sq, int Sk, int d,
                                   int causal, int q_offset, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 32: return launch<32>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 64: return launch<64>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 128: return launch<128>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int BH, int Sq, int Sk, int d,
                                    int causal, int q_offset, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!(hp::aligned(q, 16) && hp::aligned(k, 16) && hp::aligned(v, 16) && hp::aligned(o, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return launch_fwd_tc<16>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 32: return launch_fwd_tc<32>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 64: return launch_fwd_tc<64>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    case 128: return launch_fwd_tc<128>(q, k, v, o, l, BH, Sq, Sk, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// D (BH, Sq) f32 is the wrapper's scratch; dq, dk, dv take q's dtype
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dO, const void* lse, void* D,
                                       void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
                                       int d, int causal, int q_offset, float scale,
                                       void* stream) {
  return bwd_dispatch<float>(q, k, v, o, dO, lse, D, dq, dk, dv, BH, Sq, Sk, d, causal,
                             q_offset, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, const void* lse, void* D,
                                        void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
                                        int d, int causal, int q_offset, float scale,
                                        void* stream) {
  if (!(hp::aligned(q, 16) && hp::aligned(k, 16) && hp::aligned(v, 16) && hp::aligned(o, 16) &&
        hp::aligned(dO, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* Db = static_cast<float*>(D);
  switch (d) {
    case 16: return launch_bwd_tc<16>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 32: return launch_bwd_tc<32>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 64: return launch_bwd_tc<64>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    case 128: return launch_bwd_tc<128>(q, k, v, o, dO, l, Db, dq, dk, dv, BH, Sq, Sk, causal, q_offset, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
