"""Launch plans of the port's kernels, checked for Hopper (the port of
``repro.kernels.validation``).

Every launch of a kernel on the card goes through a :class:`KernelPlan`
built here: the wrapper builds the plan from its operands and the tiles it
resolved, and launches the instantiation the plan names. A builder raises
``ValueError`` for anything the kernel cannot take, before any launch: a
tile outside the compiled set, shared memory above a block's 232448
bytes, a ring of fewer than two stages, more than 1024 threads, a grid y
above 65535, a tensor map whose base or strides are not 16-byte aligned
or whose box is too large, dims past int32, a head width or an N:M pattern
that is not compiled. So a candidate that builds is a candidate that
launches (``kernels.tuning``). The builders are memoised by their
arguments (an operand's address by its alignment), so a launch whose
plan was built before looks it up.

The reference's plan is a VMEM footprint of BlockSpecs; here it is what a
Hopper launch is made of: the grid, the threads of a block, its dynamic
shared memory and ring stages (by the formulas of ``csrc/gemm.cuh`` and
``csrc/flash_attention.cu``, which ``chip_smoke.py`` holds to the compiled
kernels' own query), the tiles, and every TMA map the kernel reads by.

The compiled tile sets:

  * the bf16 GEMMs (masked_matmul's four routes, 2-D and batched, and
    nm_spmm): (bm, bn) in :data:`GEMM_TILES`, 256 x 128 the default; bk is
    64, the 128-byte swizzle row of bf16, on every tile;
  * the bf16 attention forward: (bq, bk) in :data:`ATTN_TILES` of its head
    width, 128 / 128 the default;
  * the f32 SIMT kernels and the attention backward keep their one tile:
    each of their plans has exactly one candidate.

The static checks read these plans: ``repro_torch.analysis.kernel_check``
(KER001-005) builds every launch a config's walk and its serving make, at
the config's full widths, and ``analysis.tuning_cache`` (TUN001-004) every
cached entry's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

SMEM_MAX = 232448   # a block's shared memory on sm_90 (hopper.cuh)
MAX_THREADS = 1024
MAX_GRID_YZ = 65535
INT_MAX = 2**31 - 1
TMA_BOX_MAX = 256
BK = 64             # the GEMMs' reduction step: 64 bf16 values, one 128-byte swizzle row
GEMM_TILES = ((256, 128), (128, 128), (128, 64))  # gemm.cuh's with_tile; the default first
GEMM_MAX_STAGES = 4
HEAD_DIMS = (16, 32, 64, 128)  # the attention kernels' compiled head widths
ATTN_TILES = {16: ((128, 128),), 32: ((128, 128),),  # flash_attention.cu's fw_with_tile
              **{d: ((128, 128), (128, 64), (64, 128), (64, 64)) for d in (64, 128)}}
ATTN_RING_KEYS = 384  # keys in flight in the attention forward's ring
NM_GROUPS = (1, 2, 4, 8)
ELEM = {"float32": 4, "bfloat16": 2}
DENSE_BUFS = 3  # nm_spmm's dense B tiles outside the ring

# the f32 SIMT kernels' fixed tiles
F32_GEMM = {"bm": 128, "bn": 128, "bk": 8}
F32_ATTN = {"bq": 64, "bk": 32}
BWD_ATTN = {"bfloat16": {"bq": 64, "bk": 64}, "float32": {"bq": 32, "bk": 32}}

# (strides in elements, address) of one operand, as the wrapper holds it
Operand = Tuple[Tuple[int, ...], int]


def _aligned(operands):
    """``operands`` as the memoised builders key them: strides as tuples,
    each address modulo 16 (only its alignment is checked). Launches whose
    operands share shapes, strides and alignment run one plan, built
    once."""
    if operands is None:
        return None
    if isinstance(operands, Mapping):
        return tuple((n, (tuple(s), a % 16)) for n, (s, a) in operands.items())
    return tuple((tuple(s), a % 16) for s, a in operands)


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One tensor map a kernel reads by: dims innermost first, the byte
    strides of dims[1:], the box (values) and the element's bytes; ``addr``
    is the base address, modulo 16 in a builder's plan."""

    name: str
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    elem: int
    addr: int = 0

    def problems(self) -> List[str]:
        out = []
        if self.addr % 16:
            out.append(f"{self.name}'s base is not 16-byte aligned")
        if any(s % 16 for s in self.strides):
            out.append(f"{self.name}'s byte strides {self.strides} are not multiples of 16")
        if max(self.box) > TMA_BOX_MAX:
            out.append(f"{self.name}'s box {self.box} has a side above {TMA_BOX_MAX}")
        if self.box[0] * self.elem % 16:
            out.append(f"{self.name}'s inner box is {self.box[0] * self.elem} bytes, "
                       "not a multiple of 16")
        return out


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """What one launch is made of. ``kernel`` is the library
    (``masked_matmul``, ``nm_spmm``, ``flash_attention``), ``route`` its
    entry (``masked_matmul_batched_dw``, ``flash_attention_bwd``, ...);
    ``smem`` is the dynamic shared memory, ``stages`` the ring's depth (0
    for the SIMT kernels, which have none)."""

    kernel: str
    route: str
    dtype: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    stages: int
    tiles: Dict[str, int]
    maps: Tuple[TmaMap, ...] = ()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up1024(b: int) -> int:
    return _cdiv(b, 1024) * 1024


def _contiguous(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _check_launch(what: str, grid, threads: int, smem: int, stages: Optional[int]) -> None:
    if smem > SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory exceed a block's {SMEM_MAX}")
    if stages is not None and stages < 2:
        raise ValueError(f"{what}: the ring has {stages} stages, fewer than 2")
    if threads > MAX_THREADS:
        raise ValueError(f"{what}: {threads} threads exceed a block's {MAX_THREADS}")
    if grid[0] > INT_MAX or grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"{what}: grid {grid} exceeds the card's ({INT_MAX}, {MAX_GRID_YZ}, "
                         f"{MAX_GRID_YZ})")


def _dtype(what: str, dtype: str) -> None:
    if dtype not in ELEM:
        raise ValueError(f"{what}: kernel takes float32 or bfloat16, got {dtype}")


# ---------------------------------------------------------------------------
# the GEMMs (gemm.cuh)
# ---------------------------------------------------------------------------
def gemm_stages(bm: int, stage: int, extra: int = 0) -> int:
    """gemm.cuh's ``Tile::stages_for``: the deepest ring (at most 4) whose
    stages, with ``extra`` bytes, the alignment slack and the barriers,
    fit."""
    return min(GEMM_MAX_STAGES,
               (SMEM_MAX - 1024 - extra - 2 * GEMM_MAX_STAGES * 8) // (bm * BK * 2 + stage))


def gemm_smem(bm: int, stage: int, extra: int = 0) -> Tuple[int, int]:
    """(dynamic shared-memory bytes, stages) of gemm.cuh's ``smem_bytes``."""
    stages = gemm_stages(bm, stage, extra)
    return 1024 + stages * (bm * BK * 2 + stage) + extra + 2 * stages * 8, stages


def _gemm_tiles(what: str, dtype: str, bm, bn, bk) -> Dict[str, int]:
    if dtype == "float32":
        asked = {k: v for k, v in (("bm", bm), ("bn", bn), ("bk", bk)) if v is not None}
        if any(F32_GEMM[k] != v for k, v in asked.items()):
            raise ValueError(f"{what}: the f32 SIMT kernel takes no tile knob (its tile is "
                             f"{F32_GEMM}), got {asked}")
        return dict(F32_GEMM)
    bm = GEMM_TILES[0][0] if bm is None else bm
    bn = GEMM_TILES[0][1] if bn is None else bn
    if bk is not None and bk != BK:
        raise ValueError(f"{what}: bk is {BK} (one 128-byte swizzle row of bf16) on every "
                         f"tile, got bk={bk}")
    if (bm, bn) not in GEMM_TILES:
        raise ValueError(f"{what}: tile bm={bm} bn={bn} is not compiled; the compiled (bm, bn) "
                         f"are {GEMM_TILES}")
    return {"bm": bm, "bn": bn, "bk": BK}


def _map3(name: str, addr: int, E: int, rows: int, cols: int, ld: int, ldz: int,
          box: Tuple[int, int], elem: int) -> TmaMap:
    """gemm.cuh's ``map3``: E slabs of (rows x cols), row stride ld and slab
    stride ldz in values (one slab's stride is its own size)."""
    return TmaMap(name, (cols, rows, E), (ld * elem, (ldz if E > 1 else rows * ld) * elem),
                  (*box, 1), elem, addr)


# per route: the operands' names and dims of (M, K, N), and the output's
_GEMM_OPS = {"masked_matmul": (("x", "MK"), ("w", "KN"), ("m", "KN"), "MN"),
             "masked_matmul_dx": (("dy", "MN"), ("w", "KN"), ("m", "KN"), "MK"),
             "masked_matmul_dw": (("x", "MK"), ("dy", "MN"), ("m", "KN"), "KN"),
             "masked_matmul_dm": (("x", "MK"), ("dy", "MN"), ("w", "KN"), "KN")}
MASKED_ROUTES = tuple(_GEMM_OPS) + tuple(r.replace("masked_matmul", "masked_matmul_batched")
                                         for r in _GEMM_OPS)


def plan_masked_matmul(route: str, M: int, K: int, N: int, E: int = 1, *,
                       bm: Optional[int] = None, bn: Optional[int] = None,
                       bk: Optional[int] = None, dtype: str = "bfloat16",
                       operands: Optional[Sequence[Operand]] = None) -> KernelPlan:
    """The plan of one launch of ``route`` (``masked_matmul``, ``_dx``,
    ``_dw``, ``_dm``, or their ``masked_matmul_batched`` entries over E
    slabs) on the forward's (M, K, N). ``operands`` are the three operands'
    (strides, address) in the route's order (contiguous at 0 when None);
    the third is the mask (uint8), or dM's weight w."""
    return _plan_masked_matmul(route, M, K, N, E, bm, bn, bk, dtype, _aligned(operands))


@functools.lru_cache(maxsize=4096)
def _plan_masked_matmul(route, M, K, N, E, bm, bn, bk, dtype, operands) -> KernelPlan:
    base = route.replace("masked_matmul_batched", "masked_matmul")
    if route not in MASKED_ROUTES:
        raise ValueError(f"unknown masked_matmul route {route!r}; one of {MASKED_ROUTES}")
    if base == route and E != 1:
        raise ValueError(f"{route}: a 2-D route takes one slab, got E={E}")
    _dtype(route, dtype)
    tiles = _gemm_tiles(route, dtype, bm, bn, bk)
    *ops, _ = _GEMM_OPS[base]
    scale = base == "masked_matmul_dm"
    dims = dict(M=M, K=K, N=N)
    lead = (E,) if route != base else ()
    if operands is None:
        operands = [(_contiguous((*lead, dims[d[0]], dims[d[1]])), 0) for _, d in ops]
    third = "weight" if scale else "mask"
    for what, (strides, _) in zip(("first operand", "second operand", third), operands):
        if strides[-1] != 1:
            raise ValueError(f"{route}: {what} needs unit column stride, got strides "
                             f"{tuple(strides)}")
    if dtype == "float32":
        plan = _plan_gemm_f32(route, base, M, K, N, E, tiles)
    else:
        plan = _plan_gemm_bf16(route, base, M, K, N, E, tiles, operands, third)
    if max(E, M, K, N) > INT_MAX:
        raise ValueError(f"{route}: dims {(E, M, K, N)} exceed int32")
    _check_launch(route, plan.grid, plan.threads, plan.smem,
                  plan.stages if dtype == "bfloat16" else None)
    return plan


def _gemm_mkn(base: str, M: int, K: int, N: int) -> Tuple[int, int, int]:
    """The kernel's (Mc, Kc, Nc) for route ``base`` (gemm.cuh's C = A @ B)."""
    return {"masked_matmul": (M, K, N), "masked_matmul_dx": (M, N, K)}.get(base, (K, M, N))


def _plan_gemm_f32(route, base, M, K, N, E, tiles) -> KernelPlan:
    Mc, _, Nc = _gemm_mkn(base, M, K, N)
    return KernelPlan("masked_matmul", route, "float32",
                      (_cdiv(Nc, tiles["bn"]), _cdiv(Mc, tiles["bm"]), E), 256, 0, 0, tiles)


def _plan_gemm_bf16(route, base, M, K, N, E, tiles, operands, third) -> KernelPlan:
    bm, bn = tiles["bm"], tiles["bn"]
    (sa, pa), (sb, pb), (sc, pc) = operands
    # row and slab strides (a 2-D operand's slab stride is its own size)
    rows = [s[-2] for s in (sa, sb, sc)]
    slabs = [s[0] if len(s) == 3 else 0 for s in (sa, sb, sc)]
    Mc, Kc, Nc = _gemm_mkn(base, M, K, N)
    if base in ("masked_matmul", "masked_matmul_dx"):
        mn = base == "masked_matmul"
        maps = (_map3("A", pa, E, Mc, Kc, rows[0], slabs[0], (64, bm), 2),
                _map3("w", pb, E, K, N, rows[1], slabs[1], (64, 64) if mn else (64, bn), 2),
                _map3("m", pc, E, K, N, rows[2], slabs[2], (bn, 64) if mn else (64, bn), 1))
        stage = BK * bn * 2 + BK * bn  # w's tile and the mask's
        epi_ok = True
    else:  # dW, dM: x read MN-major, dy as it is; the third operand in the epilogue
        maps = (_map3("A", pa, E, Kc, Mc, rows[0], slabs[0], (64, 64), 2),
                _map3("dy", pb, E, Kc, Nc, rows[1], slabs[1], (64, 64), 2))
        stage = BK * bn * 2
        # read beside each output pair: the mask's rows and slabs 16 bytes
        # apart, dM's w's 8 values; a 16-byte-aligned base
        unit = 8 if third == "weight" else 16
        epi_ok = rows[2] % unit == 0 and slabs[2] % unit == 0 and pc % 16 == 0
    problems = [p for mp in maps for p in mp.problems()]
    if not (K % 8 == 0 and N % 8 == 0 and epi_ok and not problems):
        raise ValueError(f"{route}: the bf16 kernel takes K, N and row strides that are "
                         "multiples of 8, a mask row stride that is a multiple of 16, on "
                         f"16-byte-aligned matrices and {third}"
                         + (f" ({'; '.join(problems)})" if problems else ""))
    smem, stages = gemm_smem(bm, stage)
    grid = (_cdiv(Mc, bm) * _cdiv(Nc, bn), E, 1)
    return KernelPlan("masked_matmul", route, "bfloat16", grid, 128 * bm // 64 + 32, smem,
                      stages, tiles, maps)


def plan_nm_spmm(M: int, K: int, N: int, *, n: int, m: int, bm: Optional[int] = None,
                 bn: Optional[int] = None, bk: Optional[int] = None,
                 dtype: str = "bfloat16",
                 operands: Optional[Sequence[Operand]] = None) -> KernelPlan:
    """The plan of one ``nm_spmm`` launch: x (M, K) against the n:m
    compressed vals and idx (K/m*n, N). ``operands``: (strides, address) of
    x, vals and idx."""
    return _plan_nm_spmm(M, K, N, n, m, bm, bn, bk, dtype, _aligned(operands))


@functools.lru_cache(maxsize=4096)
def _plan_nm_spmm(M, K, N, n, m, bm, bn, bk, dtype, operands) -> KernelPlan:
    what = "nm_spmm"
    if m not in NM_GROUPS or not 1 <= n <= m:
        raise ValueError(f"nm_spmm: kernel takes m in {NM_GROUPS} and 1 <= n <= m, "
                         f"got {n}:{m}")
    _dtype(what, dtype)
    tiles = _gemm_tiles(what, dtype, bm, bn, bk)
    if operands is None:
        operands = [((K, 1), 0), ((N, 1), 0), ((N, 1), 0)]
    for name, (strides, _) in zip(("x", "vals", "idx"), operands):
        if strides[-1] != 1:
            raise ValueError(f"nm_spmm: {name} needs unit column stride, got {tuple(strides)}")
    if K % m:
        raise ValueError(f"nm_spmm: K={K} is not a multiple of m={m}")
    rows = K // m * n
    if dtype == "float32":
        plan = KernelPlan("nm_spmm", what, dtype, (_cdiv(N, 128), _cdiv(M, 128), 1), 256, 0, 0,
                          tiles)
    else:
        bm, bn = tiles["bm"], tiles["bn"]
        (sx, px), (sv, pv), (si, pi) = operands
        steps = BK // m * n  # compressed rows of a K step
        maps = (_map3("x", px, 1, M, K, sx[0], 0, (64, bm), 2),
                TmaMap("vals", (N, rows), (sv[0] * 2,), (bn, steps), 2, pv),
                TmaMap("idx", (N, rows), (si[0],), (bn, steps), 1, pi))
        problems = [p for mp in maps for p in mp.problems()]
        if K % 8 or N % 8 or problems:
            # every operand goes by TMA: 16-byte-aligned bases, row strides of 16 bytes
            raise ValueError("nm_spmm: the bf16 kernel takes K, N and the row strides of x and "
                             "vals multiples of 8, idx's row stride a multiple of 16, and "
                             "16-byte-aligned operands"
                             + (f" ({'; '.join(problems)})" if problems else ""))
        stage = _up1024(steps * bn * 2) + _up1024(steps * bn)
        smem, stages = gemm_smem(bm, stage, DENSE_BUFS * BK * bn * 2)
        plan = KernelPlan("nm_spmm", what, dtype, (_cdiv(M, bm) * _cdiv(N, bn), 1, 1),
                          128 * bm // 64 + 32, smem, stages, tiles, maps)
    if max(M, K, N) > INT_MAX:
        raise ValueError(f"nm_spmm: dims {(M, K, N)} exceed int32")
    _check_launch(what, plan.grid, plan.threads, plan.smem,
                  plan.stages if dtype == "bfloat16" else None)
    return plan


# ---------------------------------------------------------------------------
# attention (flash_attention.cu)
# ---------------------------------------------------------------------------
def attn_forward_smem(d: int, bq: int, bk: int) -> Tuple[int, int]:
    """(dynamic shared-memory bytes, stages) of flash_attention.cu's
    ``FwTile``: Q, a ring of K and V tiles as deep as ATTN_RING_KEYS keys
    and the shared memory allow, and the barriers."""
    q_bytes, kv_bytes = bq * d * 2, 2 * bk * d * 2
    fit = (SMEM_MAX - 1024 - q_bytes - 8) // (kv_bytes + 16)
    stages = min(fit, ATTN_RING_KEYS // bk)
    return 1024 + q_bytes + stages * kv_bytes + (2 * stages + 1) * 8, stages


def plan_flash_attention(BH: int, Sq: int, Sk: int, d: int, *, bq: Optional[int] = None,
                         bk: Optional[int] = None, dtype: str = "bfloat16",
                         causal: bool = True, q_offset: int = 0,
                         route: str = "flash_attention",
                         operands: Optional[Mapping[str, Operand]] = None) -> KernelPlan:
    """The plan of one launch of the attention forward (``route``
    ``flash_attention``) or its backward (``flash_attention_bwd``) on q
    (BH, Sq, d) against k, v (BH, Sk, d). ``operands`` maps q, k, v (and o,
    do) to their (strides, address). Only the bf16 forward takes tiles; the
    others keep their one."""
    if q_offset + Sq + Sk > INT_MAX:
        raise ValueError("flash_attention: sequence positions exceed int32")
    # q_offset moves the causal diagonal, not the plan: decode's steps share one
    return _plan_flash_attention(BH, Sq, Sk, d, bq, bk, dtype, route, _aligned(operands))


@functools.lru_cache(maxsize=4096)
def _plan_flash_attention(BH, Sq, Sk, d, bq, bk, dtype, route, operands) -> KernelPlan:
    if route not in ("flash_attention", "flash_attention_bwd"):
        raise ValueError(f"unknown flash_attention route {route!r}")
    _dtype(route, dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if BH > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid's {MAX_GRID_YZ}")
    seqs = {"q": Sq, "k": Sk, "v": Sk, "o": Sq, "do": Sq}
    operands = dict(operands or {n: (_contiguous((BH, seqs[n], d)), 0) for n in "qkv"})
    if any(tuple(operands[n][0]) != _contiguous((BH, seqs[n], d)) for n in "qkv"):
        raise ValueError("flash_attention: kernel takes contiguous (BH, S, d) operands")
    asked = {k: v for k, v in (("bq", bq), ("bk", bk)) if v is not None}
    if route == "flash_attention" and dtype == "bfloat16":
        tiles = {"bq": 128, "bk": 128, **asked}
        if (tiles["bq"], tiles["bk"]) not in ATTN_TILES[d]:
            raise ValueError(f"{route}: tile bq={tiles['bq']} bk={tiles['bk']} is not compiled "
                             f"at head_dim {d}; the compiled (bq, bk) are {ATTN_TILES[d]}")
    else:
        tiles = dict(F32_ATTN if route == "flash_attention" else BWD_ATTN[dtype])
        if any(tiles[k] != v for k, v in asked.items()):
            raise ValueError(f"{route}: the {dtype} kernel takes no tile knob (its tile is "
                             f"{tiles}), got {asked}")
    maps: Tuple[TmaMap, ...] = ()
    if dtype == "bfloat16":
        maps = tuple(TmaMap(n, (d, seqs[n], BH), (d * 2, seqs[n] * d * 2),
                            (min(d, 64), 64, 1), 2, operands[n][1]) for n in operands)
        if any(mp.problems() for mp in maps):
            raise ValueError(f"{route}: the bf16 kernel takes 16-byte-aligned operands")
    bq_, bk_ = tiles["bq"], tiles["bk"]
    stages = None
    if route == "flash_attention" and dtype == "bfloat16":
        smem, stages = attn_forward_smem(d, bq_, bk_)
        threads, grid = 128 * bq_ // 64 + 32, (_cdiv(Sq, bq_), BH, 1)
    elif route == "flash_attention":  # the f32 SIMT forward
        smem = 4 * (bq_ * (d + 1) + bk_ * (d + 1) + bk_ * d + bq_ * (bk_ + 1) + bq_)
        threads, grid = 128, (_cdiv(Sq, bq_), BH, 1)
    elif dtype == "bfloat16":  # the wgmma backward: the dK/dV kernel's grid
        smem, stages = 1024 + 6 * 64 * d * 2 + 2 * 64 * 4 + 4 * 8, 2
        threads, grid = 128, (_cdiv(Sk, bk_), BH, 1)
    else:
        smem = 4 * (2 * bq_ * (d + 1) + 2 * bk_ * (d + 1) + 2 * bq_ * (bk_ + 1) + 2 * bq_)
        threads, grid = 256, (_cdiv(Sk, bk_), BH, 1)
    _check_launch(route, grid, threads, smem, stages)
    return KernelPlan("flash_attention", route, dtype, grid, threads, smem, stages or 0, tiles,
                      maps)
