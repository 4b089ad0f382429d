"""The port's kernel modules on the CPU: each plain version against the
JAX Pallas kernel run in interpret mode and against its jnp oracle, over
the shapes and dtypes of ``tests/test_kernels.py``; and the wrappers'
contract (CPU tensor -> plain version, anything else -> kernel or raise).

Stated tolerances, as the reference kernel tests: masked matmul 2e-5 in
f32 and 2e-2 in bf16; flash attention 1e-4 in f32 and 3e-2 in bf16.
"""
from __future__ import annotations

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
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
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


@pytest.mark.parametrize("case", ["K", "N", "x stride", "x address"])
def test_bf16_masked_matmul_launch_rejects_unaligned_operands(case):
    """The bf16 kernel loads 16-byte chunks; it takes no other operands."""
    K, N, x = 16, 16, _bf16(4, 16)
    if case == "K":
        K, x = 12, _bf16(4, 12)
    elif case == "N":
        N = 12
    elif case == "x stride":
        x = _bf16(4, 20)[:, :16]
    else:
        x = _bf16(4 * 16 + 1)[1:].view(4, 16)
    w, m = _bf16(K, N), torch.ones(K, N, dtype=torch.bool)
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        MM._launch(x, w, m)


def test_bf16_flash_attention_launch_rejects_unaligned_operands():
    q = _bf16(1, 4, 16)
    k = _bf16(1 * 4 * 16 + 1)[1:].view(1, 4, 16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        FA._launch(q, k, q, True, 0)


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
