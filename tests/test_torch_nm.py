"""The port's N:M re-pack and nm_spmm against the JAX package, on the CPU.

``nm_compress`` and ``nm_decompress`` must equal the reference's bit for
bit, ties and all-kept groups included. The plain ``nm_spmm`` is held to
the reference's oracle and to its Pallas kernel run in interpret mode at
2e-5 in f32 and 2e-2 in bf16, as ``tests/test_kernels.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nm_spmm.nm_spmm import nm_spmm as ref_nm_spmm_kernel
from repro.kernels.nm_spmm.ref import nm_spmm_ref
from repro.sparsity import sparse_params as RSP
from repro_torch import interop
from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm import ops as NM
from repro_torch.kernels.nm_spmm.ref import nm_spmm_plain
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _mask_case(case, rng, R, O, n, m):
    """N:M masks from scores (ties forced by rounding), and masks whose
    groups keep all, none or fewer than n of their slots."""
    if case == "scores":
        return np.asarray(RSP.nm_mask(jnp.asarray(rng.random((R, O)).astype(np.float32)), n, m))
    if case == "ties":
        scores = np.round(rng.random((R, O)) * 2).astype(np.float32)  # values 0, 1, 2
        return np.asarray(RSP.nm_mask(jnp.asarray(scores), n, m))
    if case == "all-kept":
        return np.ones((R, O), np.float32)
    mask = (rng.random((R, O)) < 0.3).astype(np.float32)  # any count per group
    mask[:m] = 0.0  # a group with nothing kept
    return mask


@pytest.mark.parametrize("case", ["scores", "ties", "all-kept", "irregular"])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
def test_nm_compress_and_decompress_bit_exact(case, n, m):
    rng = np.random.default_rng(n * 10 + m)
    R, O = 8 * m, 24
    w = rng.normal(size=(R, O)).astype(np.float32)
    mask = _mask_case(case, rng, R, O, n, m)
    ref_vals, ref_idx = RSP.nm_compress(jnp.asarray(w), jnp.asarray(mask), n, m)
    for tmask in (torch.tensor(mask), torch.tensor(mask != 0)):  # f32 or bool mask
        vals, idx = SP.nm_compress(torch.tensor(w), tmask, n, m)
        assert idx.dtype == torch.int8 and vals.dtype == torch.float32
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    back = SP.nm_decompress(vals, idx, n, m)
    np.testing.assert_array_equal(back.numpy(), np.asarray(RSP.nm_decompress(ref_vals, ref_idx,
                                                                             n, m)))
    if case in ("scores", "ties"):  # an exact N:M mask round-trips
        np.testing.assert_array_equal(back.numpy(), w * mask)


def test_nm_compress_keeps_a_bf16_weight_in_bf16():
    w = torch.randn(16, 8).to(torch.bfloat16)
    mask = SP.nm_mask(torch.rand(16, 8), 2, 4)
    vals, idx = SP.nm_compress(w, mask, 2, 4)
    assert vals.dtype == torch.bfloat16 and vals.shape == idx.shape == (8, 8)
    assert torch.equal(SP.nm_decompress(vals, idx, 2, 4), w * mask)


def _nm_operands(rng, M, K, N, n, m, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), dtype=jdt)
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32), dtype=jdt)
    mask = RSP.nm_mask(jnp.asarray(rng.random((K, N)).astype(np.float32)), n, m)
    vals, idx = RSP.nm_compress(w, mask.astype(jdt), n, m)
    return x, vals, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
@pytest.mark.parametrize("M,K,N", [(8, 128, 128), (64, 256, 384)])
def test_nm_spmm_plain_matches_reference_and_pallas(M, K, N, n, m, dtype):
    rng = np.random.default_rng(M + K + n)
    x, vals, idx = _nm_operands(rng, M, K, N, n, m, dtype)
    tx, tv = interop._tensor(np.asarray(x), "cpu"), interop._tensor(np.asarray(vals), "cpu")
    ti = torch.tensor(np.asarray(idx))
    out = NM.nm_spmm(tx, tv, ti, n=n, m=m)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    tol = TOL[dtype]
    for ref in (nm_spmm_ref(x, vals, idx, n=n, m=m),
                ref_nm_spmm_kernel(x, vals, idx, n=n, m=m, interpret=True)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


def test_nm_spmm_equals_the_masked_product():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(64, 32)).astype(np.float32))
    mask = SP.nm_mask(torch.tensor(rng.random((64, 32)).astype(np.float32)), 2, 4)
    x = torch.tensor(rng.normal(size=(5, 64)).astype(np.float32))
    vals, idx = SP.nm_compress(w, mask, 2, 4)
    torch.testing.assert_close(nm_spmm_plain(x, vals, idx, n=2, m=4), x @ (w * mask))


def test_nm_spmm_wrapper_contract(monkeypatch, tmp_path):
    x, v, i = torch.zeros(4, 16), torch.zeros(8, 3), torch.zeros(8, 3, dtype=torch.int8)
    before = NM.launches
    assert NM.nm_spmm(x, v, i, n=2, m=4).shape == (4, 3) and NM.launches == before
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        NM.nm_spmm(x, v[:6], i[:6], n=2, m=4)
    meta = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        NM.nm_spmm(meta, v.to("meta"), i.to("meta"), n=2, m=4)
    with pytest.raises(TypeError, match="int8"):
        NM._launch(x, v, i.to(torch.int32), 2, 4)
    with pytest.raises(TypeError, match="f32 or bf16"):
        NM._launch(x.half(), v.half(), i, 2, 4)
    with pytest.raises(ValueError, match="m in"):
        NM._launch(torch.zeros(4, 48), torch.zeros(8, 3), torch.zeros(8, 3, dtype=torch.int8),
                   1, 6)
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        NM._launch(torch.zeros(4, 12, dtype=torch.bfloat16), torch.zeros(6, 3).bfloat16(),
                   torch.zeros(6, 3, dtype=torch.int8), 2, 4)
    # asked for a launch with no toolkit, the kernel path fails at the build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        NM._launch(x, v, i, 2, 4)


@pytest.mark.parametrize("case", ["aligned", "N", "vals stride", "idx stride", "vals address",
                                  "idx address"])
def test_bf16_nm_spmm_launch_rejects_operands_the_tma_cannot_take(case, monkeypatch):
    """The bf16 kernel reads x, vals and idx by TMA: 16-byte-aligned bases
    and row strides of 16 bytes (8 bf16 values, 16 offset bytes), so N a
    multiple of 8. The wrapper refuses other operands before any launch;
    aligned ones reach the library."""
    def load(name):
        raise RuntimeError("launched")

    monkeypatch.setattr(_build, "load", load)
    K, N, n, m = 16, 16, 2, 4
    x = torch.zeros(4, K, dtype=torch.bfloat16)
    vals = torch.zeros(K // m * n, N, dtype=torch.bfloat16)
    idx = torch.zeros(K // m * n, N, dtype=torch.int8)
    if case == "N":
        vals, idx = vals[:, :12].contiguous(), idx[:, :12].contiguous()
    elif case == "vals stride":  # 40 bytes
        vals = torch.zeros(K // m * n, 20, dtype=torch.bfloat16)[:, :N]
    elif case == "idx stride":  # 24 bytes: a multiple of 8, not of 16
        idx = torch.zeros(K // m * n, 24, dtype=torch.int8)[:, :N]
    elif case == "vals address":
        vals = torch.zeros(vals.numel() + 1, dtype=torch.bfloat16)[1:].view(vals.shape)
    elif case == "idx address":
        idx = torch.zeros(idx.numel() + 8, dtype=torch.int8)[8:].view(idx.shape)
    if case == "aligned":
        with pytest.raises(RuntimeError, match="launched"):
            NM._launch(x, vals, idx, n, m)
    else:
        with pytest.raises(ValueError, match="bf16 kernel takes"):
            NM._launch(x, vals, idx, n, m)
