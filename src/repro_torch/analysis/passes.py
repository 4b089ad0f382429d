"""Pass drivers: wire the checkers to real configs and models (the port
of ``repro.analysis.passes``).

The kernel and config passes run on the **exact published config
numbers** (pure shape math, no compute). The mask and graph passes need a
traced graph, so they trace each config's SMOKE variant — same family,
same code path, tiny shapes — on the CPU, once: the EBFT tune step of each
block kind (the loss, ``torch.autograd.grad``, the port's Adam and
``apply_updates``), which both passes read, and the serving decode step.
Traces are cached by the SMOKE variant's name, which several configs
share.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch import tree as T
from repro_torch.analysis.config_check import check_model_config
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_lint import lint_graph
from repro_torch.analysis.graph_utils import trace
from repro_torch.analysis.kernel_check import check_config_kernels
from repro_torch.analysis.mask_check import check_mask_tree, mask_taints, taint_graph
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reconstruction as R
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.sparsity import sparse_params as SP

# one model per distinct smoke config, and its traces
_MODEL_CACHE: Dict[str, Tuple] = {}
_TRACE_CACHE: Dict[Tuple[str, object], Tuple] = {}


def _smoke_model(smoke_cfg: ModelConfig):
    key = smoke_cfg.name
    if key not in _MODEL_CACHE:
        from repro_torch.models.model import build

        model = build(smoke_cfg)
        params = model.init(torch.Generator().manual_seed(0))
        _MODEL_CACHE[key] = (model, params)
    return _MODEL_CACHE[key]


def _block_indices(model) -> List[int]:
    """Block 0 plus one representative of each *other* block kind (MoE
    expert block, hybrid shared-attention block, encdec decoder block)."""
    cfg = model.cfg
    idx = [0]
    if cfg.family == "moe" and cfg.moe_first_dense > 0:
        idx.append(cfg.moe_first_dense)
    if cfg.family == "hybrid":
        idx.append(model.num_blocks - 1)
    if cfg.family == "encdec":
        idx.append(cfg.enc_layers)
    return idx


def _block_io(model, i: int, B: int = 2, S: int = 8):
    cfg = model.cfg
    g = torch.Generator().manual_seed(i)
    dt = torch_dtype(cfg.dtype)
    h = torch.randn((B, S, cfg.d_model), generator=g).to(dt)
    pos = torch.arange(S)[None, :]
    aux = {}
    if cfg.family == "encdec" and i >= cfg.enc_layers:
        aux = {"memory": torch.randn((B, S, cfg.d_model), generator=g).to(dt)}
    return h, pos, aux


def tune_step_graph(smoke: ModelConfig, i: int):
    """(the aten graph of one EBFT tune step of block ``i``, the mask
    taints of its placeholders): ``core.ebft.tune_block``'s inner step on
    clones of the block's weights, under all-ones masks."""
    key = (smoke.name, i)
    if key not in _TRACE_CACHE:
        model, params = _smoke_model(smoke)
        bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        model.get_block(params, i))
        masks = SP.ones_masks(bw)
        h, pos, aux = _block_io(model, i)
        opt = adam(2e-4)

        def tune_step(bw_, masks_, h_, target_, pos_, aux_):
            leaves = [t for _, t in T.leaves_with_path(bw_)]
            with torch.enable_grad():
                loss = R.block_loss(model, i, bw_, masks_, h_, target_, pos_, aux_)
                grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            updates, _ = opt.update(T.tree_map(lambda _: next(it), bw_), opt.init(bw_), bw_)
            apply_updates(bw_, updates)
            return loss.detach()

        args = (bw, masks, h, h, pos, aux)
        _TRACE_CACHE[key] = (trace(tune_step, *args), mask_taints(*args))
    return _TRACE_CACHE[key]


def decode_step_graph(smoke: ModelConfig):
    """The aten graph of one serving decode step of the smoke model (two
    sequences, a fresh cache of 16 positions)."""
    key = (smoke.name, "decode")
    if key not in _TRACE_CACHE:
        model, params = _smoke_model(smoke)
        state = model.init_serve_state(2, 16, "cpu")
        tok = torch.zeros((2, 1), dtype=torch.int32)
        _TRACE_CACHE[key] = trace(model.decode_step, params, tok, state)
    return _TRACE_CACHE[key]


# ---------------------------------------------------------------------------
def run_kernel_pass(name: str, cfg: ModelConfig, smoke: ModelConfig) -> List[Finding]:
    return check_config_kernels(name, cfg)


def run_sharding_pass(name: str, cfg: ModelConfig, smoke: ModelConfig) -> List[Finding]:
    """CFG001–007; the SHD rules wait for the distributed layer (ROADMAP.md
    A.8)."""
    return check_model_config(name, cfg)


def run_mask_pass(name: str, cfg: ModelConfig, smoke: ModelConfig) -> List[Finding]:
    """Prove Eq.-4 mask dominance on the traced tune step of every block
    kind, then validate a concrete N:M mask tree for one block."""
    findings: List[Finding] = []
    model, params = _smoke_model(smoke)

    for i in _block_indices(model):
        where = f"ebft.tune_step[{R.block_kind(model, i)}]"
        try:
            gm, taints = tune_step_graph(smoke, i)
            findings += taint_graph(gm, taints, where, config=name)
        except Exception as e:
            findings.append(Finding(
                code="MSK000", severity="warn", pass_name="masks",
                config=name, location=f"block{i}",
                message=f"could not trace the tune step: {type(e).__name__}: {e}",
            ))

    # concrete-pattern validation: build a 2:4 mask for block 0 and check it
    bw = model.get_block(params, 0)

    def make_mask(path, leaf):
        if SP.is_prunable(path, leaf):
            mat, tag = SP.to_matrix(path[-1], leaf.abs())
            if mat.shape[-2] % 4 == 0:
                return SP.from_matrix(SP.nm_mask(mat, 2, 4), tag)
            return torch.ones(leaf.shape, dtype=torch.bool)
        return torch.ones((), dtype=torch.bool)

    masks_b = T.map_with_path(make_mask, bw)
    nm_ok = all(SP.to_matrix(p[-1], leaf)[0].shape[-2] % 4 == 0
                for p, leaf in T.leaves_with_path(bw) if SP.is_prunable(p, leaf))
    findings += check_mask_tree(masks_b, bw, nm=(2, 4) if nm_ok else None, config=name)
    return findings


def run_graph_pass(name: str, cfg: ModelConfig, smoke: ModelConfig) -> List[Finding]:
    """Lint the EBFT tune step of every block kind and the serving decode
    step of the smoke model."""
    findings: List[Finding] = []
    model, _ = _smoke_model(smoke)
    for i in _block_indices(model):
        where = f"ebft.tune_step[{R.block_kind(model, i)}]"
        try:
            findings += lint_graph(tune_step_graph(smoke, i)[0], where=where, config=name)
        except Exception as e:
            findings.append(Finding(
                code="LNT000", severity="warn", pass_name="graph",
                config=name, location=where,
                message=f"could not trace the tune step: {type(e).__name__}: {e}",
            ))
    try:
        findings += lint_graph(decode_step_graph(smoke), where="serving.decode_step",
                               config=name)
    except Exception as e:
        findings.append(Finding(
            code="LNT000", severity="warn", pass_name="graph",
            config=name, location="serving.decode_step",
            message=f"could not trace the decode step: {type(e).__name__}: {e}",
        ))
    return findings


PASSES = {
    "kernels": run_kernel_pass,
    "masks": run_mask_pass,
    "graph": run_graph_pass,
    "sharding": run_sharding_pass,
}
