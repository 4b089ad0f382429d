"""The port's kernel modules on the CPU: each plain version against the
JAX Pallas kernel run in interpret mode and against its jnp oracle, over
the shapes and dtypes of ``tests/test_kernels.py``; and the wrappers'
contract (CPU tensor -> plain version, anything else -> kernel or raise).

Stated tolerances, as the reference kernel tests: masked matmul 2e-5 in
f32 and 2e-2 in bf16; flash attention 1e-4 in f32 and 3e-2 in bf16. The
gradients (``MaskedMatmulFn``, ``FlashAttentionFn``) are held to
``jax.grad`` of the reference oracles at 1e-5 in f32 (the same sums in
another order) and to ``torch.autograd.gradcheck`` in f64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as RFA
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.masked_matmul import ops as RMM
from repro.kernels.masked_matmul.ref import masked_matmul_ref
from repro_torch import interop, resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_lse_plain, flash_attention_plain,
)
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.masked_matmul.ref import masked_matmul_plain

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jdt, _ = DTYPES[dtype]
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype=jdt)
    return j, interop._tensor(np.asarray(j), "cpu")


def _close(port, ref, dtype, f32=2e-5, bf16=2e-2):
    tol = bf16 if dtype == "bfloat16" else f32
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# masked matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (16, 256, 512), (128, 384, 256), (1, 128, 640)])
def test_masked_matmul_plain_matches_pallas_and_ref(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    xj, xt = _pair(rng, (m, k), dtype)
    wj, wt = _pair(rng, (k, n), dtype)
    mask = rng.random((k, n)) > 0.5
    out = masked_matmul_plain(xt, wt, torch.tensor(mask))
    assert out.dtype == xt.dtype and out.shape == (m, n)
    _close(out, RMM.masked_matmul(xj, wj, jnp.asarray(mask), interpret=True), dtype)
    _close(out, masked_matmul_ref(xj, wj, jnp.asarray(mask)), dtype)


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.float32])
def test_masked_matmul_wrapper_on_cpu_is_the_plain_version(mask_dtype):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(5, 33)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(33, 7)).astype(np.float32))
    m = torch.tensor(rng.random((33, 7)) > 0.5).to(mask_dtype)
    before = MM.launches
    torch.testing.assert_close(MM.masked_matmul(x, w, m), masked_matmul_plain(x, w, m),
                               rtol=0, atol=0)
    assert MM.launches == before  # the plain version is no launch


def test_masked_matmul_all_masked_is_zero():
    x = torch.randn(8, 128)
    w = torch.randn(128, 128)
    assert float(MM.masked_matmul(x, w, torch.zeros(128, 128, dtype=torch.bool)).abs().max()) == 0.0


@pytest.mark.parametrize("shapes", [((4, 8), (9, 3), (9, 3)), ((4, 8), (8, 3), (8, 4)),
                                    ((2, 4, 8), (8, 3), (8, 3))])
def test_masked_matmul_rejects_bad_shapes(shapes):
    xs, ws, ms = shapes
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        MM.masked_matmul(torch.zeros(xs), torch.zeros(ws), torch.zeros(ms, dtype=torch.bool))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", [(4, 256, 64), (2, 128, 128)])
def test_flash_attention_plain_matches_pallas_and_ref(bh, s, hd, causal, dtype):
    rng = np.random.default_rng(bh + s + hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (bh, s, hd), dtype) for _ in range(3))
    out = flash_attention_plain(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype
    _close(out, RFA.flash_attention(qj, kj, vj, causal=causal, interpret=True), dtype,
           f32=1e-4, bf16=3e-2)
    _close(out, flash_attention_ref(qj, kj, vj, causal=causal), dtype, f32=1e-4, bf16=3e-2)


@pytest.mark.parametrize("sq,q_offset", [(1, 127), (64, 64), (32, 10)])
def test_flash_attention_plain_q_offset(sq, q_offset):
    """Shifted causal diagonal with Sq < Sk (a chunk of queries late in the
    key timeline), against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sq)
    qj, qt = _pair(rng, (2, sq, 64), "float32")
    kj, kt = _pair(rng, (2, 128, 64), "float32")
    vj, vt = _pair(rng, (2, 128, 64), "float32")
    out = FA.flash_attention(qt, kt, vt, causal=True, q_offset=q_offset)
    ref = RFA.flash_attention(qj, kj, vj, causal=True, q_offset=q_offset, interpret=True)
    _close(out, ref, "float32", f32=1e-4)


@pytest.mark.parametrize("causal,sq,sk,q_offset", [(True, 64, 64, 0), (False, 64, 96, 0),
                                                    (True, 32, 128, 96), (True, 1, 128, 127)])
def test_flash_attention_lse_plain_matches_the_reference_attention(causal, sq, sk, q_offset):
    """The plain row log-sum-exp, which the forward kernels write for the
    backward, against the JAX reference on the same inputs: it equals
    ``jax.nn.logsumexp`` of the reference's masked f32 scores, and
    exp(scores - lse) @ v is the reference's attention."""
    rng = np.random.default_rng(sq + sk + q_offset)
    qj, qt = _pair(rng, (2, sq, 32), "float32")
    kj, kt = _pair(rng, (2, sk, 32), "float32")
    vj, _ = _pair(rng, (2, sk, 32), "float32")
    lse = flash_attention_lse_plain(qt, kt, causal=causal, q_offset=q_offset)
    assert lse.shape == (2, sq) and lse.dtype == torch.float32
    s = jnp.einsum("bqd,bkd->bqk", qj, kj) / np.sqrt(32.0)
    if causal:
        keep = (q_offset + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
        s = jnp.where(keep, s, -1e30)
    _close(lse, jax.nn.logsumexp(s, axis=-1), "float32", f32=1e-5)
    o = jnp.einsum("bqk,bkd->bqd", jnp.exp(s - jnp.asarray(lse.numpy())[..., None]), vj)
    np.testing.assert_allclose(np.asarray(o), np.asarray(
        flash_attention_ref(qj, kj, vj, causal=causal, q_offset=q_offset)), rtol=1e-5, atol=1e-5)


def test_flash_attention_bshd_matches_reference_adapter():
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (2, 64, 4, 32), "float32")
    kj, kt = _pair(rng, (2, 64, 4, 32), "float32")
    vj, vt = _pair(rng, (2, 64, 4, 32), "float32")
    out = FA.flash_attention_bshd(qt, kt, vt, causal=True)
    assert out.shape == (2, 64, 4, 32)
    ref = RFA.flash_attention_bshd(qj, kj, vj, causal=True, interpret=True)
    _close(out, ref, "float32", f32=1e-4)


def test_flash_attention_rejects_bad_input():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        FA.flash_attention(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))
    with pytest.raises(ValueError, match="q_offset"):
        FA.flash_attention(q, q, q, q_offset=-1)


# ---------------------------------------------------------------------------
# no fallback: without a card the kernel path raises
# ---------------------------------------------------------------------------
def test_wrappers_raise_for_a_device_without_kernel():
    t = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        MM.masked_matmul(t, t, torch.empty(4, 4, dtype=torch.bool, device="meta"))
    q = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        FA.flash_attention(q, q, q)


def test_kernel_launch_without_nvcc_raises(monkeypatch, tmp_path):
    """Asked for a launch on a machine with no toolkit, the wrapper's
    kernel path fails at the build; it does not run the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    x = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        MM._launch(x, torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.bool))
    q = torch.zeros(1, 4, 16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FA._launch(q, q, q, True, 0)


def test_kernel_launch_rejects_operands_it_cannot_take():
    x = torch.zeros(4, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        MM._launch(x, x.T.contiguous(), torch.zeros(8, 4, dtype=torch.bool))
    with pytest.raises(TypeError, match="mask"):
        MM._launch(torch.zeros(4, 8), torch.zeros(8, 4), torch.zeros(8, 4))
    with pytest.raises(ValueError, match="column stride"):
        MM._launch(torch.zeros(8, 4).T, torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.bool))
    q = torch.zeros(1, 4, 24)
    with pytest.raises(ValueError, match="head_dim"):
        FA._launch(q, q, q, True, 0)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["K", "N", "x stride", "x address", "mask stride",
                                  "mask address"])
def test_bf16_masked_matmul_launch_rejects_unaligned_operands(case):
    """The bf16 kernel reads every operand by TMA: 16-byte-aligned bases,
    row strides of 16 bytes (8 bf16 values, 16 mask bytes); it takes no
    other operands."""
    K, N, x = 16, 16, _bf16(4, 16)
    m = torch.ones(K, N, dtype=torch.bool)
    if case == "K":
        K, x, m = 12, _bf16(4, 12), torch.ones(12, N, dtype=torch.bool)
    elif case == "N":
        N, m = 12, torch.ones(K, 12, dtype=torch.bool)
    elif case == "x stride":
        x = _bf16(4, 20)[:, :16]
    elif case == "x address":
        x = _bf16(4 * 16 + 1)[1:].view(4, 16)
    elif case == "mask stride":  # 24 bytes: a multiple of 8, not of 16
        m = torch.ones(K, 24, dtype=torch.bool)[:, :16]
    else:
        m = torch.ones(K * N + 8, dtype=torch.bool)[8:].view(K, N)
    w = _bf16(K, N)
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        MM._launch(x, w, m)


def test_bf16_flash_attention_launch_rejects_unaligned_operands():
    q = _bf16(1, 4, 16)
    k = _bf16(1 * 4 * 16 + 1)[1:].view(1, 4, 16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        FA._launch(q, k, q, True, 0)


@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do"])
def test_bf16_flash_attention_bwd_rejects_unaligned_operands(which):
    """The bf16 backward reads q, k, v and do by TMA (and o row by row):
    16-byte-aligned operands only, refused before any launch."""
    ops = {n: _bf16(1, 4, 16) for n in ("q", "k", "v", "o", "do")}
    ops[which] = _bf16(1 * 4 * 16 + 1)[1:].view(1, 4, 16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        FA._launch_bwd(ops["q"], ops["k"], ops["v"], ops["o"], ops["do"],
                       torch.zeros(1, 4), True, 0)


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# gradients: the kernels under autograd (MaskedMatmulFn, FlashAttentionFn)
# ---------------------------------------------------------------------------
def _leaf(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype).requires_grad_(True)


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (5, 33, 7)])
def test_masked_matmul_gradients_equal_jax_grad(m, k, n):
    """The Function's backward (the plain dX and dW on the CPU) against
    jax.grad of the reference oracle, f32 at 1e-5; pruned slots of dW are
    exactly 0."""
    rng = np.random.default_rng(k)
    x, w = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    mask = rng.random((k, n)) > 0.5
    dy = rng.normal(size=(m, n)).astype(np.float32)
    jx, jw = jax.grad(lambda a, b: jnp.sum(masked_matmul_ref(a, b, jnp.asarray(mask)) * dy),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _leaf(x), _leaf(w)
    out = MM.masked_matmul(tx, tw, torch.tensor(mask))
    assert type(out.grad_fn).__name__ == "MaskedMatmulFnBackward"
    gx, gw = torch.autograd.grad(out, (tx, tw), torch.tensor(dy))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    assert bool((gw[~torch.tensor(mask)] == 0.0).all())
    torch.testing.assert_close(gx, MM.masked_matmul_dx(torch.tensor(dy), tw.detach(),
                                                       torch.tensor(mask)), rtol=0, atol=0)


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_masked_matmul_gradcheck_f64(needs):
    rng = np.random.default_rng(1)
    x = _leaf(rng.normal(size=(6, 10)), torch.float64).requires_grad_(needs != "w")
    w = _leaf(rng.normal(size=(10, 4)), torch.float64).requires_grad_(needs != "x")
    mask = torch.tensor(rng.random((10, 4)) > 0.4)
    assert torch.autograd.gradcheck(lambda a, b: MM.masked_matmul(a, b, mask), (x, w))


def test_masked_matmul_without_grad_is_the_plain_forward():
    x, w = torch.randn(4, 8, requires_grad=True), torch.randn(8, 3)
    m = torch.rand(8, 3) > 0.5
    with torch.no_grad():
        out = MM.masked_matmul(x, w, m)
    assert out.grad_fn is None
    torch.testing.assert_close(out, masked_matmul_plain(x.detach(), w, m), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_matmul_grad_plain_versions_match_jax_vjp(dtype):
    rng = np.random.default_rng(5)
    (xj, xt), (wj, wt), (dj, dt) = (_pair(rng, s, dtype) for s in ((16, 128), (128, 64), (16, 64)))
    mask = rng.random((128, 64)) > 0.5
    _, vjp = jax.vjp(lambda a, b: masked_matmul_ref(a, b, jnp.asarray(mask)), xj, wj)
    jx, jw = vjp(dj)
    dx = MM.masked_matmul_dx(dt, wt, torch.tensor(mask))
    dw = MM.masked_matmul_dw(xt, dt, torch.tensor(mask))
    assert dx.dtype == dw.dtype == xt.dtype
    _close(dx, jx, dtype)
    _close(dw, jw * mask, dtype, bf16=5e-2)  # dW sums 16 products of O(1) in bf16


def test_masked_matmul_grad_wrappers_validate():
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        MM.masked_matmul_dx(torch.zeros(4, 5), torch.zeros(8, 4), torch.zeros(8, 4))
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        MM.masked_matmul_dw(torch.zeros(4, 8), torch.zeros(3, 5), torch.zeros(8, 5))
    with pytest.raises(ValueError, match="operands on"):
        MM.masked_matmul_dx(torch.zeros(4, 4), torch.zeros(8, 4, device="meta"),
                            torch.zeros(8, 4))
    t = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        MM.masked_matmul_dw(t, t, torch.empty(4, 4, dtype=torch.bool, device="meta"))
    before = (MM.dx_launches, MM.dw_launches)
    MM.masked_matmul_dx(torch.zeros(2, 4), torch.zeros(3, 4), torch.ones(3, 4))
    MM.masked_matmul_dw(torch.zeros(2, 3), torch.zeros(2, 4), torch.ones(3, 4))
    assert (MM.dx_launches, MM.dw_launches) == before  # the plain versions are no launch


def test_grad_kernels_without_nvcc_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    m = torch.ones(8, 4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        MM._launch_dx(torch.zeros(2, 4), torch.zeros(8, 4), m)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        MM._launch_dw(torch.zeros(2, 8), torch.zeros(2, 4), m)
    q = torch.zeros(1, 4, 16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        FA._launch_bwd(q, q, q, q, q, torch.zeros(1, 4), True, 0)


def _attn_inputs(rng, bh, sq, sk, d):
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, sk, sk, sq)]


@pytest.mark.parametrize("causal,sq,sk,q_offset", [(True, 32, 32, 0), (False, 24, 40, 0),
                                                   (True, 8, 40, 32), (True, 20, 33, 13)])
def test_flash_attention_gradients_equal_jax_grad(causal, sq, sk, q_offset):
    """FlashAttentionFn's backward (the plain formula on the CPU) against
    jax.grad of the reference oracle, f32 at 1e-5; its forward's
    log-sum-exp against jax's."""
    rng = np.random.default_rng(sq + sk)
    q, k, v, do = _attn_inputs(rng, 3, sq, sk, 16)
    kw = dict(causal=causal, q_offset=q_offset)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [_leaf(a) for a in (q, k, v)]
    out = FA.flash_attention(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, torch.tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    s = jnp.einsum("bqd,bkd->bqk", q, k) / np.sqrt(16)
    if causal:
        s = jnp.where(q_offset + jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :], s, -1e30)
    _, lse = flash_attention_plain(*map(torch.tensor, (q, k, v)), **kw, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0), (True, 5)])
def test_flash_attention_gradcheck_f64(causal, q_offset):
    rng = np.random.default_rng(2)
    q, k, v, _ = _attn_inputs(rng, 2, 6, 9, 8)
    leaves = [_leaf(a, torch.float64) for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: FA.flash_attention(a, b, c, causal=causal, q_offset=q_offset), leaves)


def test_flash_attention_bshd_carries_the_gradient():
    rng = np.random.default_rng(4)
    q, k, v = (_leaf(rng.normal(size=(2, 16, 4, 16))) for _ in range(3))
    out = FA.flash_attention_bshd(q, k, v, causal=True)
    (out.square().sum()).backward()
    assert all(t.grad is not None and float(t.grad.abs().sum()) > 0 for t in (q, k, v))


def test_flash_attention_bwd_validates_shapes():
    q = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        FA.flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 5))
    before = FA.bwd_launches
    FA.flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 4))
    assert FA.bwd_launches == before


def test_a_library_is_stale_when_a_shared_header_is_newer(monkeypatch, tmp_path):
    """``csrc/*.cuh`` headers are shared by several sources: touching one
    rebuilds every library."""
    import os

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    (csrc / "k.cu").write_text("")
    assert _build._stale("k")  # no library yet
    lib = build / "libk.so"
    lib.write_text("")
    os.utime(csrc / "k.cu", (1, 1))
    os.utime(lib, (2, 2))
    assert not _build._stale("k")
    (csrc / "tile.cuh").write_text("")
    os.utime(csrc / "tile.cuh", (3, 3))
    assert _build._stale("k")
