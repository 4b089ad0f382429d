"""The port's launch plans (``repro_torch.kernels.validation``): every
launch's checks on the CPU, where the kernels cannot run.

  * the plans refuse exactly what the wrappers' checks refused before there
    were plans, with the same messages (the old checks are kept below as
    the oracle) and nothing else, over a sweep of operand layouts;
  * their shared memory, stages and threads equal the sums of
    ``csrc/gemm.cuh`` and ``csrc/flash_attention.cu`` worked by hand for
    every compiled tile (``chip_smoke.py`` holds the same numbers to the
    compiled kernels' own query on the card);
  * tiles outside the compiled set, knobs the f32 kernels do not take and
    launches past the card's limits raise ValueError before any launch,
    and the tiles of the plan are what the library is handed;
  * ``kernels.dispatch``, the uniform entry point.
"""
from __future__ import annotations

import itertools

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels import validation as V
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.nm_spmm import ops as NM

BF = torch.bfloat16


# ---------------------------------------------------------------------------
# the wrappers' checks as they stood before the plans (the oracle)
# ---------------------------------------------------------------------------
def old_masked_check(fn, a, b, m):
    name = MM._entry(fn, a)
    scale = fn == "masked_matmul_dm"
    if not scale:
        m = m.view(torch.uint8) if m.dtype in (torch.bool, torch.int8) else m
    third = "weight" if scale else "mask"
    batched = a.dim() == 3
    M, K, N = MM._mkn(fn, a, b)
    for what, t in (("first operand", a), ("second operand", b), (third, m)):
        if t.stride(-1) != 1:
            return f"{name}: {what} needs unit column stride, got strides {t.stride()}"
    strides = [t.stride(-2) for t in (a, b, m)] + ([t.stride(0) for t in (a, b, m)]
                                                   if batched else [])
    if a.dtype == BF and not (
            K % 8 == 0 and N % 8 == 0
            and all(st % 8 == 0 for st in strides)
            and all(st % (8 if scale else 16) == 0 for st in strides[2::3])
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and m.data_ptr() % 16 == 0):
        return (f"{name}: the bf16 kernel takes K, N and row strides that are "
                "multiples of 8, a mask row stride that is a multiple of 16, on "
                f"16-byte-aligned matrices and {third}")
    return None


def _view(shape, dtype, pad: int, offset: int):
    """A tensor of ``shape`` whose rows are ``pad`` values longer than its
    last dim, starting ``offset`` values into its storage; with ``pad`` -1
    the transpose of a contiguous tensor (a column stride that is not 1)."""
    *lead, r, c = shape
    if pad < 0:
        return torch.zeros(*lead, c, r, dtype=dtype).transpose(-1, -2)
    n = 1
    for d in lead:
        n *= d
    base = torch.zeros(n * r * (c + pad) + offset + 8, dtype=dtype)[offset:]
    t = base[:n * r * (c + pad)].view(*lead, r, c + pad)[..., :c]
    return t


MASKED_CASES = list(itertools.product(
    ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "masked_matmul_dm"),
    (False, True),                    # batched
    ((16, 16), (12, 16), (16, 12)),   # (K, N)
    (-1, 0, 4, 8, 16),                # row padding of the operand bent (-1: transposed)
    (0, 1, 8),                        # storage offset of the operand bent
    (0, 1, 2)))                       # which operand is bent


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plans_refuse_exactly_what_the_old_checks_refused(dtype):
    """Over routes, 2-D and batched, widths, row paddings, offsets and the
    operand they bend: the plan refuses where the old check refused, with
    its message, and builds where it built."""
    refused = built = 0
    for fn, batched, (K, N), pad, off, which in MASKED_CASES:
        M = 8
        lead = (2,) if batched else ()
        names = [d for _, d in MM._OPERANDS[fn][:3]]
        dims = dict(M=M, K=K, N=N)
        ops = []
        for i, d in enumerate(names):
            third = i == 2 and fn != "masked_matmul_dm"
            dt = torch.bool if third else dtype
            shape = (*lead, dims[d[0]], dims[d[1]])
            ops.append(_view(shape, dt, pad, off) if i == which else torch.zeros(shape, dtype=dt))
        want = old_masked_check(fn, *ops)
        if want is None:
            MM.check_operands(fn, *ops)
            built += 1
        else:
            with pytest.raises(ValueError) as err:
                MM.check_operands(fn, *ops)
            assert str(err.value).startswith(want), (fn, batched, K, N, pad, off, which)
            refused += 1
    assert refused and built


def old_nm_check(x, vals, idx, n, m):
    if m not in (1, 2, 4, 8) or not 1 <= n <= m:
        return "nm_spmm: kernel takes m in"
    for name, t in (("x", x), ("vals", vals), ("idx", idx)):
        if t.stride(1) != 1:
            return f"nm_spmm: {name} needs unit column stride"
    M, K = x.shape
    N = vals.shape[1]
    if K % m:
        return f"nm_spmm: K={K} is not a multiple of m={m}"
    if x.dtype == BF and not (
            K % 8 == 0 and N % 8 == 0 and x.stride(0) % 8 == 0 and vals.stride(0) % 8 == 0
            and idx.stride(0) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, vals, idx))):
        return "nm_spmm: the bf16 kernel takes K, N and the row strides of x and vals"
    return None


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_nm_plans_refuse_what_the_old_checks_refused(dtype):
    for (K, N), (n, m), pad, off, which in itertools.product(
            ((16, 16), (12, 16), (16, 12)), ((2, 4), (1, 8), (3, 3)), (0, 4, 8, 16), (0, 1, 8),
            range(3)):
        if K % m and (n, m) != (3, 3):
            continue
        rows = K // m * n
        shapes = [(4, K), (rows, N), (rows, N)]
        dts = [dtype, dtype, torch.int8]
        ops = [_view(s, d, pad, off) if i == which else torch.zeros(s, dtype=d)
               for i, (s, d) in enumerate(zip(shapes, dts))]
        want = old_nm_check(*ops, n, m)
        if want is None:
            NM._plan(*ops, n, m, {})
        else:
            with pytest.raises(ValueError, match=want.split(" got")[0][:40]):
                NM._plan(*ops, n, m, {})


def test_attention_plans_refuse_what_the_old_checks_refused():
    q = torch.zeros(2, 8, 64, dtype=BF)
    odd = torch.zeros(2 * 8 * 64 + 1, dtype=BF)[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="head_dim"):
        FA._plan(torch.zeros(1, 4, 24), torch.zeros(1, 4, 24), torch.zeros(1, 4, 24), True, 0,
                 "flash_attention", {})
    with pytest.raises(ValueError, match="contiguous"):
        FA._plan(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, True, 0,
                 "flash_attention", {})
    for route in ("flash_attention", "flash_attention_bwd"):
        with pytest.raises(ValueError, match=f"{route}: the bf16 kernel takes 16-byte-aligned"):
            FA._plan(q, odd, q, True, 0, route, {})
    FA._plan(odd.float(), odd.float(), odd.float(), True, 0, "flash_attention", {})  # f32: no TMA
    with pytest.raises(ValueError, match="exceeds the grid"):
        V.plan_flash_attention(70000, 1, 8, 64)
    with pytest.raises(ValueError, match="exceed int32"):
        V.plan_flash_attention(1, 8, 8, 64, q_offset=2**31 - 8)
    with pytest.raises(TypeError, match="f32 or bf16"):
        FA._plan(q.half(), q.half(), q.half(), True, 0, "flash_attention", {})


# ---------------------------------------------------------------------------
# shared memory, stages and threads of every compiled tile, by hand
# ---------------------------------------------------------------------------
A = {256: 256 * 64 * 2, 128: 128 * 64 * 2}          # A's tile
B = {128: 64 * 128 * 2, 64: 64 * 64 * 2}            # w's or dy's tile
MASK = {128: 64 * 128, 64: 64 * 64}                 # the uint8 mask tile

GEMM_HAND = {
    # (route, bm, bn): (smem, stages): 1024 slack + stages x (A + B (+ mask)) + 2 barriers a stage
    ("masked_matmul", 256, 128): (1024 + 4 * (A[256] + B[128] + MASK[128]) + 64, 4),  # 230464
    ("masked_matmul", 128, 128): (1024 + 4 * (A[128] + B[128] + MASK[128]) + 64, 4),  # 164928
    ("masked_matmul", 128, 64): (1024 + 4 * (A[128] + B[64] + MASK[64]) + 64, 4),     # 115776
    ("masked_matmul_dw", 256, 128): (1024 + 4 * (A[256] + B[128]) + 64, 4),           # 197696
    ("masked_matmul_dw", 128, 128): (1024 + 4 * (A[128] + B[128]) + 64, 4),           # 132160
    ("masked_matmul_dw", 128, 64): (1024 + 4 * (A[128] + B[64]) + 64, 4),             # 99392
}


@pytest.mark.parametrize("key", sorted(GEMM_HAND))
@pytest.mark.parametrize("batched", [False, True])
def test_gemm_shared_memory_and_stages_by_hand(key, batched):
    route, bm, bn = key
    smem, stages = GEMM_HAND[key]
    routes = [route, route.replace("_dw", "_dm") if "_dw" in route else route + "_dx"]
    for r in routes:
        if batched:
            r = r.replace("masked_matmul", "masked_matmul_batched")
        plan = V.plan_masked_matmul(r, 4096, 1024, 2048, 3 if batched else 1, bm=bm, bn=bn)
        assert (plan.smem, plan.stages, plan.threads) == (smem, stages, 128 * bm // 64 + 32), r
        assert plan.tiles == {"bm": bm, "bn": bn, "bk": 64}
        assert plan.grid[1] == (3 if batched else 1)
    assert GEMM_HAND[("masked_matmul", 256, 128)][0] == 230464  # gemm.cuh's default, unchanged


def _nm_hand(n, m, bm, bn):
    steps = 64 // m * n
    up = lambda b: -(-b // 1024) * 1024  # noqa: E731 - each part on a 1024-byte boundary
    stage, extra = up(steps * bn * 2) + up(steps * bn), 3 * 64 * bn * 2
    stages = min(4, (232448 - 1024 - extra - 64) // (A[bm] + stage))
    return 1024 + stages * (A[bm] + stage) + extra + 16 * stages, stages


@pytest.mark.parametrize("bm,bn", V.GEMM_TILES)
def test_nm_shared_memory_and_stages_by_hand(bm, bn):
    hand = {(2, 4): {(256, 128): (230464, 4), (128, 128): (164928, 4), (128, 64): (115776, 4)},
            (1, 8): {(256, 128): (193600, 4), (128, 128): (128064, 4), (128, 64): (99392, 4)},
            (8, 8): {(256, 128): (222256, 3), (128, 128): (214080, 4), (128, 64): (140352, 4)}}
    for (n, m), by_tile in hand.items():
        plan = V.plan_nm_spmm(256, 4096, 1024, n=n, m=m, bm=bm, bn=bn)
        assert (plan.smem, plan.stages) == by_tile[(bm, bn)] == _nm_hand(n, m, bm, bn), (n, m)
    for n, m in ((n, m) for m in V.NM_GROUPS for n in range(1, m + 1)):
        plan = V.plan_nm_spmm(256, 4096, 1024, n=n, m=m, bm=bm, bn=bn)
        assert (plan.smem, plan.stages) == _nm_hand(n, m, bm, bn) and plan.stages >= 2


ATTN_HAND = {
    # (d, bq, bk): (smem, stages): 1024 + Q (bq d 2) + stages x K and V (2 bk d 2) + barriers;
    # stages = min(what fits, 384 keys / bk)
    (16, 128, 128): (1024 + 128 * 16 * 2 + 3 * 2 * 128 * 16 * 2 + 7 * 8, 3),   # 29752
    (32, 128, 128): (1024 + 128 * 32 * 2 + 3 * 2 * 128 * 32 * 2 + 7 * 8, 3),   # 58424
    (64, 128, 128): (1024 + 128 * 64 * 2 + 3 * 2 * 128 * 64 * 2 + 7 * 8, 3),   # 115768
    (64, 128, 64): (1024 + 128 * 64 * 2 + 6 * 2 * 64 * 64 * 2 + 13 * 8, 6),   # 115816
    (64, 64, 128): (1024 + 64 * 64 * 2 + 3 * 2 * 128 * 64 * 2 + 7 * 8, 3),     # 107576
    (64, 64, 64): (1024 + 64 * 64 * 2 + 6 * 2 * 64 * 64 * 2 + 13 * 8, 6),     # 107624
    (128, 128, 128): (1024 + 128 * 128 * 2 + 3 * 2 * 128 * 128 * 2 + 7 * 8, 3),  # 230456
    (128, 128, 64): (1024 + 128 * 128 * 2 + 6 * 2 * 64 * 128 * 2 + 13 * 8, 6),   # 230504
    (128, 64, 128): (1024 + 64 * 128 * 2 + 3 * 2 * 128 * 128 * 2 + 7 * 8, 3),    # 214072
    (128, 64, 64): (1024 + 64 * 128 * 2 + 6 * 2 * 64 * 128 * 2 + 13 * 8, 6),    # 214120
}


@pytest.mark.parametrize("key", sorted(ATTN_HAND))
def test_attention_shared_memory_and_stages_by_hand(key):
    d, bq, bk = key
    plan = V.plan_flash_attention(256, 2048, 2048, d, bq=bq, bk=bk)
    assert (plan.smem, plan.stages) == ATTN_HAND[key]
    assert plan.threads == 128 * bq // 64 + 32 and plan.grid == (2048 // bq, 256, 1)
    assert [mp.box for mp in plan.maps] == [(min(d, 64), 64, 1)] * 3
    assert set(ATTN_HAND) == {(d, bq, bk) for d, tiles in V.ATTN_TILES.items()
                              for bq, bk in tiles}


def test_attention_backward_and_f32_plans_keep_their_one_tile():
    bwd = V.plan_flash_attention(8, 128, 128, 128, route="flash_attention_bwd")
    assert bwd.tiles == {"bq": 64, "bk": 64} and bwd.threads == 128
    assert bwd.smem == 1024 + 6 * 64 * 128 * 2 + 2 * 64 * 4 + 4 * 8
    f32 = V.plan_flash_attention(8, 128, 128, 64, dtype="float32")
    assert f32.tiles == {"bq": 64, "bk": 32} and f32.threads == 128 and f32.maps == ()
    assert f32.smem == 4 * (64 * 65 + 32 * 65 + 32 * 64 + 64 * 33 + 64)
    for route, tiles in (("flash_attention_bwd", {"bq": 128}), ("flash_attention", {"bk": 64})):
        with pytest.raises(ValueError, match="takes no tile knob"):
            V.plan_flash_attention(8, 128, 128, 128, route=route,
                                   dtype="float32" if route == "flash_attention" else "bfloat16",
                                   **tiles)
    gemm = V.plan_masked_matmul("masked_matmul_dw", 300, 96, 40, dtype="float32")
    assert gemm.tiles == V.F32_GEMM and gemm.threads == 256 and gemm.grid == (1, 1, 1)
    with pytest.raises(ValueError, match="takes no tile knob"):
        V.plan_masked_matmul("masked_matmul", 8, 16, 16, dtype="float32", bm=128, bn=64)


# ---------------------------------------------------------------------------
# refusals before any launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tiles,match", [
    ({"bm": 64, "bn": 128}, "is not compiled"), ({"bm": 256, "bn": 64}, "is not compiled"),
    ({"bk": 128}, "bk is 64"), ({"bm": 512, "bn": 128}, "is not compiled")])
def test_gemm_tiles_outside_the_compiled_set_raise(tiles, match):
    with pytest.raises(ValueError, match=match):
        V.plan_masked_matmul("masked_matmul", 64, 64, 64, **tiles)
    with pytest.raises(ValueError, match=match):
        V.plan_nm_spmm(64, 64, 64, n=2, m=4, **tiles)


def test_attention_tiles_outside_the_compiled_set_raise():
    for d, tiles in ((16, {"bq": 64}), (32, {"bk": 64}), (128, {"bq": 32}), (64, {"bk": 256})):
        with pytest.raises(ValueError, match="is not compiled"):
            V.plan_flash_attention(8, 128, 128, d, **tiles)


def test_launch_limits_raise():
    with pytest.raises(ValueError, match="grid"):  # E slabs on the grid's y
        V.plan_masked_matmul("masked_matmul_batched", 8, 64, 64, E=65536)
    V.plan_masked_matmul("masked_matmul_batched", 8, 64, 64, E=65535)
    with pytest.raises(ValueError, match="exceed int32"):
        V.plan_masked_matmul("masked_matmul", 2**31, 64, 64)
    with pytest.raises(ValueError, match="one slab"):
        V.plan_masked_matmul("masked_matmul", 8, 64, 64, E=2)
    with pytest.raises(ValueError, match="unknown masked_matmul route"):
        V.plan_masked_matmul("masked_matmul_dq", 8, 64, 64)
    with pytest.raises(ValueError, match="m in"):
        V.plan_nm_spmm(8, 48, 64, n=1, m=6)
    for smem, stages, threads, grid, match in (
            (V.SMEM_MAX + 1, 2, 128, (1, 1, 1), "shared memory"),
            (1024, 1, 128, (1, 1, 1), "fewer than 2"),
            (1024, 2, 1056, (1, 1, 1), "threads"),
            (1024, 2, 128, (1, 65536, 1), "grid")):
        with pytest.raises(ValueError, match=match):
            V._check_launch("k", grid, threads, smem, stages)


def test_tma_map_rules():
    ok = V.TmaMap("t", (64, 8, 1), (128, 1024), (64, 64, 1), 2, 0)
    assert ok.problems() == []
    assert len(V.TmaMap("t", (64, 8, 1), (136, 1088), (64, 64, 1), 2, 8).problems()) == 2
    assert "box" in V.TmaMap("t", (64, 8, 1), (128, 1024), (64, 512, 1), 2).problems()[0]
    assert "inner box" in V.TmaMap("t", (64, 8, 1), (128, 1024), (4, 8, 1), 2).problems()[0]


def test_plans_are_built_once_for_each_shape_and_alignment():
    """A launch whose operands share another's shapes, strides and
    alignment reads that launch's plan; a misaligned base still raises,
    and decode's moving q_offset shares one attention plan."""
    ops = [((64, 1), 16), ((48, 1), 32), ((48, 1), 48)]
    one = V.plan_masked_matmul("masked_matmul", 32, 64, 48, operands=ops)
    assert V.plan_masked_matmul("masked_matmul", 32, 64, 48,
                                operands=[(s, a + 4096) for s, a in ops]) is one
    assert [mp.addr for mp in one.maps] == [0, 0, 0]
    with pytest.raises(ValueError, match="16-byte-aligned"):
        V.plan_masked_matmul("masked_matmul", 32, 64, 48, operands=[ops[0], ((48, 1), 40),
                                                                       ops[2]])
    ops = {n: ((1024 * 128, 128, 1), 0) for n in "kv"}
    plans = {id(V.plan_flash_attention(8, 1, 1024, 128, q_offset=off,
                                       operands={"q": ((128, 128, 1), 0), **ops}))
             for off in range(3, 9)}
    assert len(plans) == 1
    with pytest.raises(ValueError, match="exceed int32"):
        V.plan_flash_attention(8, 1, 1024, 128, q_offset=2**31 - 1024)


class _FakeLib:
    """Stands in for a kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def entry(*args):
            self.calls.append((fn, args))
            return 0
        return entry


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("fn", ["masked_matmul", "masked_matmul_dx", "masked_matmul_dw",
                                "masked_matmul_dm"])
@pytest.mark.parametrize("bm,bn", V.GEMM_TILES)
def test_the_library_is_handed_the_plans_tiles(fake_lib, fn, bm, bn):
    """A launch hands the library the tiles of its plan (the bf16 entries'
    last two ints before the stream), counts once, and a tile outside the
    set raises before the library is reached."""
    x, w, dy = torch.zeros(16, 32, dtype=BF), torch.zeros(32, 48, dtype=BF), \
        torch.zeros(16, 48, dtype=BF)
    m = torch.ones(32, 48, dtype=torch.bool)
    ops = {"masked_matmul": (x, w, m), "masked_matmul_dx": (dy, w, m),
           "masked_matmul_dw": (x, dy, m), "masked_matmul_dm": (x, dy, w)}[fn]
    launch = getattr(MM, "_launch" + fn.removeprefix("masked_matmul"))
    counter = MM._COUNTER[fn]
    before = getattr(MM, counter)
    launch(*ops, bm=bm, bn=bn)
    (name, args), = fake_lib.calls
    assert name == f"{fn}_bf16" and args[-3:-1] == (bm, bn)
    assert getattr(MM, counter) == before + 1
    with pytest.raises(ValueError, match="is not compiled"):
        launch(*ops, bm=64, bn=64)
    assert len(fake_lib.calls) == 1 and getattr(MM, counter) == before + 1
    launch(*ops)  # no tiles, tuner off: the default plan
    assert fake_lib.calls[-1][1][-3:-1] == V.GEMM_TILES[0]
    MM.launch_uncounted(fn, *ops, {"bm": bm, "bn": bn})  # the tuner's: not counted
    assert getattr(MM, counter) == before + 2


def test_nm_and_attention_are_handed_their_tiles(fake_lib):
    x, v, i = (torch.zeros(16, 32, dtype=BF), torch.zeros(16, 16, dtype=BF),
               torch.zeros(16, 16, dtype=torch.int8))
    NM._launch(x, v, i, 2, 4, bm=128, bn=64)
    q = torch.zeros(2, 64, 128, dtype=BF)
    FA._launch(q, q, q, True, 0, bq=64, bk=64)
    FA._launch(q, q, q, True, 0)
    FA._launch(q.float(), q.float(), q.float(), True, 0)
    assert [c[0] for c in fake_lib.calls] == ["nm_spmm_bf16", "flash_attention_bf16",
                                              "flash_attention_bf16", "flash_attention_f32"]
    assert fake_lib.calls[0][1][-3:-1] == (128, 64)
    assert fake_lib.calls[1][1][-3:-1] == (64, 64) and fake_lib.calls[2][1][-3:-1] == (128, 128)
    assert len(fake_lib.calls[3][1]) == len(_build.SIGNATURES["flash_attention"][
        "flash_attention_f32"])


def test_explicit_tiles_on_the_cpu_are_checked_and_run_the_plain_version():
    x, w = torch.randn(8, 16), torch.randn(16, 16)
    m = torch.rand(16, 16) < 0.5
    before = MM.launches
    torch.testing.assert_close(MM.masked_matmul(x.bfloat16(), w.bfloat16(), m, bm=128, bn=64),
                               MM.masked_matmul(x.bfloat16(), w.bfloat16(), m))
    with pytest.raises(ValueError, match="is not compiled"):
        MM.masked_matmul(x.bfloat16(), w.bfloat16(), m, bm=64)
    with pytest.raises(ValueError, match="takes no tile knob"):
        MM.masked_matmul(x, w, m, bm=256, bn=128)
    with pytest.raises(ValueError, match="is not compiled"):
        q = torch.zeros(1, 4, 16, dtype=BF)
        FA.flash_attention(q, q, q, bq=64, bk=64)  # head width 16 has only 128 / 128
    assert MM.launches == before


def test_dispatch_is_the_uniform_entry_point():
    assert kernels.names() == ("masked_matmul", "nm_spmm", "flash_attention")
    x, w = torch.randn(8, 16), torch.randn(16, 8)
    m = torch.rand(16, 8) < 0.5
    torch.testing.assert_close(kernels.dispatch("masked_matmul", x, w, m),
                               MM.masked_matmul(x, w, m))
    q = torch.randn(2, 8, 3, 16)
    torch.testing.assert_close(kernels.dispatch("flash_attention", q, q, q, layout="bshd"),
                               FA.flash_attention_bshd(q, q, q))
    vals, idx = torch.randn(8, 8), torch.zeros(8, 8, dtype=torch.int8)
    torch.testing.assert_close(kernels.dispatch("nm_spmm", x, vals, idx, n=2, m=4),
                               NM.nm_spmm(x, vals, idx, n=2, m=4))
    with pytest.raises(KeyError, match="unknown kernel"):
        kernels.dispatch("conv", x)
