"""The baselines on the port's hybrid family against the JAX reference, on
the CPU: tiny_hybrid (Zamba2-1.2B's SMOKE: 2 groups of 2 Mamba blocks,
each group followed by the one shared attention block, and a trailing
Mamba block; d 64) at S = 32, 16 calibration and 16 evaluation segments.
The walk visits the shared block at each site: SparseGPT and DSnoT
prune it at each, mask tuning tunes it at each, every visit starting from
the masks the previous site left and writing its own back, as the
reference's. Mask tuning and LoRA run at settings where the reference's
SSD gradient stays finite (ROADMAP.md C.4), which the tests assert.
Tolerances as ``_torch_baselines`` states them.
"""
from __future__ import annotations

import pytest
import torch

from _torch_baselines import (
    adapter_shapes, check_driver, check_lora, check_mask_tuning, check_prune, make_pair,
    ref_lora, ref_mask_tuning, ref_prunes,
)
from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.core.masks import prune
from repro_torch.core.pruning import common as C

from _torch_threads import one_thread_module  # noqa: F401



@pytest.fixture(scope="module")
def pair():
    return make_pair("tiny_hybrid")


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
def test_prune_matches_reference(pair, refs, method):
    flips = check_prune(pair, refs, method)
    print(f"tiny_hybrid {method}: {flips} near-tie flips")


def test_conv_w_takes_wandas_mask_and_no_update(pair, refs):
    masks, pruned = prune(pair["model"], pair["params"], pair["calib"], method="sparsegpt",
                          sparsity=0.7)
    for group in ("groups", "trailing"):
        want = refs["wanda"]["masks"][group]["conv_w"]
        assert torch.equal(masks[group]["conv_w"], want), group
        assert torch.equal(pruned[group]["conv_w"], pair["params"][group]["conv_w"] * want)


def test_lora_adapter_shapes_are_the_references(pair):
    """The grouped Mamba leaves flatten over their stack axes as the
    reference's ``to_matrix`` takes them (``out`` (G, K, H, P, d): its two
    leading axes are the reduction, so (G·K, H·P·d)); the unstacked shared
    block's leaves are the matrices they are."""
    shapes = adapter_shapes(pair)
    G, K = pair["params"]["groups"]["out"].shape[:2]
    assert shapes["groups/out"][0] == (G * K, 8)
    assert shapes["groups/in_x"][0] == (G, 8)
    d = pair["cfg"].d_model
    assert shapes["shared/mlp/w_up"][0] == (d, 8)
    assert shapes["shared/attn/wq"][0] == (d, 8)


def test_finetune_masks_matches_reference_site_by_site(pair, refs, ref_mt, monkeypatch):
    """Against the reference's run, and in its order: the walk visits the
    shared block at both sites, the second starting from the masks the
    first left and both moving them; the final shared masks are the second
    site's."""
    seen = []
    walk = C.walk_blocks

    def spy(model, params, calib, visit_fn, *a, masks=None, **kw):
        def visit(i, bp, ctx):
            before = T.tree_map(torch.clone, model.get_block(masks, i))
            out = visit_fn(i, bp, ctx)
            seen.append((i, ctx["site"], before,
                         T.tree_map(torch.clone, model.get_block(masks, i))))
            return out

        return walk(model, params, calib, visit, *a, masks=masks, **kw)

    monkeypatch.setattr(C, "walk_blocks", spy)
    masks = check_mask_tuning(pair, refs, ref_mt)
    model = pair["model"]
    assert [(i, s) for i, s, *_ in seen] == \
        [(i, s) for seg in R.execution_plan(model) for i, s in seg.visits]
    shared = pair["cfg"].num_layers
    sites = [(b, a) for i, _, b, a in seen if i == shared]
    assert len(sites) == 2

    def same(x, y):
        return all(torch.equal(m, T.get_path(y, p)) for p, m in T.leaves_with_path(x))

    assert same(sites[1][0], sites[0][1])
    assert not same(sites[0][0], sites[0][1]) and not same(sites[1][0], sites[1][1])
    assert same(sites[1][1], masks["shared"])


def test_finetune_lora_matches_reference(pair, refs, ref_lr):
    check_lora(pair, refs, ref_lr)


def test_ebft_run_baselines_match_reference(pair, refs, ref_mt, ref_lr, monkeypatch):
    res = check_driver(pair, refs, ref_mt, ref_lr, monkeypatch)
    assert len(res.baselines["mask"]["histories"]) == pair["cfg"].num_layers + 2
