"""The baselines on the port's SSM family against the JAX reference, on the
CPU: tiny_ssm (Mamba2-130M's SMOKE: 2 Mamba blocks, d 64) at S = 32, 16
calibration and 16 evaluation segments. SparseGPT gives ``conv_w``
Wanda's mask and no update and DSnoT keeps its init mask, as the
reference's; mask tuning and LoRA backpropagate through the SSD, at
settings where the reference's SSD gradient stays finite (ROADMAP.md
C.4), which the tests assert. Tolerances as ``_torch_baselines`` states
them.
"""
from __future__ import annotations

import pytest
import torch

from _torch_baselines import (
    adapter_shapes, check_driver, check_lora, check_mask_tuning, check_prune, make_pair,
    one_thread, ref_lora, ref_mask_tuning, ref_prunes,
)
from repro_torch import tree as T
from repro_torch.core.masks import prune
from repro_torch.core.pruning import common as C

__all__ = ["one_thread"]


@pytest.fixture(scope="module")
def pair():
    return make_pair("tiny_ssm")


@pytest.fixture(scope="module")
def refs(pair):
    return ref_prunes(pair)


@pytest.fixture(scope="module")
def ref_mt(pair, refs):
    return ref_mask_tuning(pair, refs)


@pytest.fixture(scope="module")
def ref_lr(pair, refs):
    return ref_lora(pair, refs)


@pytest.mark.parametrize("method", ["sparsegpt", "dsnot"])
def test_prune_matches_reference(pair, refs, method, one_thread):
    flips = check_prune(pair, refs, method)
    print(f"tiny_ssm {method}: {flips} near-tie flips")


def test_conv_w_takes_wandas_mask_and_no_update(pair, refs, one_thread):
    """SparseGPT's ``conv_w`` is Wanda's mask on the dense taps, no update;
    DSnoT's is its init (Wanda's) mask; the taps' Gram over the conv's
    channels is not taken, and the in-projections share one stats object."""
    want = refs["wanda"]["masks"]["blocks"]["conv_w"]
    dense = pair["params"]["blocks"]["conv_w"]
    for method in ("sparsegpt", "dsnot"):
        masks, pruned = prune(pair["model"], pair["params"], pair["calib"], method=method,
                              sparsity=0.7)
        assert torch.equal(masks["blocks"]["conv_w"], want), method
        assert torch.equal(pruned["blocks"]["conv_w"], dense * want), method
    model = pair["model"]
    h, pos = model.embed_tokens(pair["params"], {"tokens": torch.as_tensor(pair["calib"][:8])})
    stats = C.collect_block_stats(model, model.get_block(pair["params"], 0), 0, [h], [pos],
                                  want_hessian=True)
    assert stats["conv_w"].hessian is None and stats["out"].hessian is not None
    assert stats["in_z"] is stats["in_x"] is stats["in_dt"]
    assert stats["in_z"].hessian.shape == (64, 64)


def test_lora_adapter_shapes_are_the_references(pair):
    """Mamba leaves flatten over their stack axes: ``out`` (L, H, P, d) is
    one (L·H, P·d) matrix; ``conv_w`` (L, K, ch) one (L, K·ch)."""
    shapes = adapter_shapes(pair)
    w = pair["params"]["blocks"]
    L, H, P, d = w["out"].shape
    assert shapes["blocks/out"] == ((L * H, 8), (8, P * d))
    assert shapes["blocks/conv_w"] == ((L, 8), (8, w["conv_w"][0].numel()))
    assert shapes["blocks/in_x"][0] == (L, 8)


def test_finetune_masks_matches_reference(pair, refs, ref_mt, one_thread):
    masks = check_mask_tuning(pair, refs, ref_mt)
    assert not torch.equal(masks["blocks"]["out"], refs["wanda"]["masks"]["blocks"]["out"])


def test_finetune_lora_matches_reference(pair, refs, ref_lr, one_thread):
    check_lora(pair, refs, ref_lr)


def test_ebft_run_baselines_match_reference(pair, refs, ref_mt, ref_lr, monkeypatch,
                                            one_thread):
    res = check_driver(pair, refs, ref_mt, ref_lr, monkeypatch)
    for path, m in T.leaves_with_path(res.baselines["dsnot"]["masks"]):
        if path[-1] == "conv_w":
            assert torch.equal(m, res.masks["blocks"]["conv_w"])


def test_baseline_masks_keep_in_dt_laid_out_for_the_kernel(one_thread):
    """On a Mamba2-130M block, SparseGPT's, DSnoT's and mask tuning's masks
    keep ``in_dt`` (768, 24) in a row-padded buffer, as ``prune``'s Wanda
    masks are: a clone of such a view is contiguous, 24 bytes a row, which
    the bf16 kernel refuses."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import mask_tuning as MT
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.models.model import build

    bf = torch.bfloat16
    x, w = torch.zeros(16, 768, dtype=bf), torch.zeros(768, 24, dtype=bf)
    model = build(get_config("mamba2_130m").replace(num_layers=1, vocab_size=512))
    params = model.init(torch.Generator().manual_seed(0))
    calib = np.random.default_rng(12).integers(0, 512, (2, 16)).astype(np.int32)
    got = {m: prune(model, params, calib, method=m, sparsity=0.7)[0]
           for m in ("wanda", "sparsegpt", "dsnot")}
    got["mask"] = MT.finetune_masks(model, params, got["wanda"], 0.7, calib,
                                    MT.EBFTConfig(lr=2e-2, epochs=1))[1]
    for method, masks in got.items():
        m = model.get_block(masks, 0)["in_dt"]
        assert m.shape == (768, 24) and m.stride() == (32, 1), method
        MM.check_operands("masked_matmul", x, w, m)
