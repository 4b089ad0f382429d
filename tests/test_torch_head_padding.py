"""Zero-padded head expansion (``repro_torch.distributed.head_padding``)
against the reference's, and the port's padded forward against its
unpadded one (the reference's ``tests/test_head_padding.py``).

Stated tolerances: the padded trees and the pad masks equal the
reference's bit for bit on the same numpy weights; the padded forward
equals the unpadded one within rtol 1e-5, atol 1e-5 (the reference
test's); a masked SGD step keeps every padded slot exactly 0.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import head_padding as RHP
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.distributed.head_padding import head_pad_mask, pad_attention_params
from repro_torch.launch.steps import padded_heads
from repro_torch.models.model import build

CASES = {"mha": (dict(num_heads=3, num_kv_heads=3, head_dim=16), dict(num_heads=4, num_kv_heads=4)),
         "gqa": (dict(num_heads=6, num_kv_heads=2, head_dim=16), dict(num_heads=8, num_kv_heads=2))}


def _cfgs(case, ref=False):
    old, new = CASES[case]
    base = (ref_get_config if ref else get_config)("tiny_dense").replace(**old)
    return base, base.replace(**new)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_padding_matches_reference_and_is_exact(case):
    """Bit for bit the reference's padded tree and pad mask; the padded
    model computes the unpadded one's logits."""
    ref_old, ref_new = _cfgs(case, ref=True)
    ref_params = ref_build(ref_old).init(jax.random.PRNGKey(0))
    cfg_old, cfg_new = _cfgs(case)
    params = interop.params_to_torch(_np(ref_params), "cpu")
    padded = pad_attention_params(params, cfg_old, cfg_new)
    ref_padded = _np(RHP.pad_attention_params(ref_params, ref_old, ref_new))
    for path, leaf in T.leaves_with_path(padded):
        np.testing.assert_array_equal(leaf.numpy(), T.get_path(ref_padded, path), err_msg=path)
    mask = head_pad_mask(padded, cfg_old, cfg_new)
    ref_mask = _np(RHP.head_pad_mask(RHP.pad_attention_params(ref_params, ref_old, ref_new),
                                     ref_old, ref_new))
    for path, leaf in T.leaves_with_path(mask):
        np.testing.assert_array_equal(leaf.numpy(), T.get_path(ref_mask, path), err_msg=path)

    m_new = build(cfg_new)
    shapes = {p: l.shape for p, l in T.leaves_with_path(m_new.init(torch.Generator()))}
    assert {p: l.shape for p, l in T.leaves_with_path(padded)} == shapes
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg_old.vocab_size, (2, 24)))
    with torch.no_grad():
        out_old = build(cfg_old).forward(params, {"tokens": toks})
        out_new = m_new.forward(padded, {"tokens": toks})
    np.testing.assert_allclose(out_old.numpy(), out_new.numpy(), rtol=1e-5, atol=1e-5)


def test_head_pad_mask_freezes_pads():
    """One masked SGD step keeps the padded q heads and wo rows exactly 0;
    without the mask wo's pad rows move (the uniform-softmax context
    reaches their gradient)."""
    cfg_old, cfg_new = _cfgs("gqa")
    params = build(cfg_old).init(torch.Generator().manual_seed(0))
    padded = pad_attention_params(params, cfg_old, cfg_new)
    mask = head_pad_mask(padded, cfg_old, cfg_new)
    m_new = build(cfg_new)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg_old.vocab_size, (2, 16)))
    leaves = [l.requires_grad_(True) for _, l in T.leaves_with_path(padded)]
    grads = torch.autograd.grad(m_new.loss(padded, {"tokens": toks})[0], leaves)
    masks = [l for _, l in T.leaves_with_path(mask)]
    with torch.no_grad():
        stepped = [p - 0.1 * g * m for p, g, m in zip(leaves, grads, masks)]
        unmasked = [p - 0.1 * g for p, g in zip(leaves, grads)]
    paths = [p for p, _ in T.leaves_with_path(padded)]
    wq = stepped[paths.index(("blocks", "attn", "wq"))]  # (L, d, 8, hd)
    assert torch.all(wq.reshape(*wq.shape[:2], 2, 4, wq.shape[-1])[:, :, :, 3:] == 0)
    i_wo = paths.index(("blocks", "attn", "wo"))  # (L, 8, hd, d)
    wo = stepped[i_wo]
    assert torch.all(wo.reshape(wo.shape[0], 2, 4, *wo.shape[2:])[:, :, 3:] == 0)
    wo2 = unmasked[i_wo]
    assert not torch.all(wo2.reshape(wo.shape[0], 2, 4, *wo.shape[2:])[:, :, 3:] == 0)


def test_padded_heads_policy():
    """The launcher's padded-head table for the assigned archs on 16."""
    assert padded_heads(get_config("qwen1_5_4b"), 16) == (32, 32)      # MHA 20
    assert padded_heads(get_config("qwen2_5_32b"), 16) == (48, 8)      # GQA 40/8
    assert padded_heads(get_config("qwen1_5_110b"), 16) == (64, 8)     # already ok
    assert padded_heads(get_config("nemotron_4_15b"), 16) == (48, 8)
    assert padded_heads(get_config("llava_next_mistral_7b"), 16) == (32, 8)
