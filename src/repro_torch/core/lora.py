"""LoRA baseline (the paper's §4.4; port of ``repro.core.lora``).

Adapters A (R × r) and B (r × O) on the canonical matrix view of every
prunable leaf; the effective weight, while tuning and when merged, is

    W_eff = (M ⊙ W) + (α/r) · M ⊙ (A B)

so the adapter's delta is masked too and the comparison with EBFT is at
equal sparsity. LoRA trains on the LM loss over the corpus (the paper's
point: EBFT reaches a better perplexity from 256 calibration samples in a
tenth of the time). Each step merges, runs ``model.loss`` with the masks
(every masked linear on the masked matmul kernel and its dX and dW),
clips the gradient to global norm 1 and takes an AdamW step.

The views are the reference's ``to_matrix`` on the whole model's stacked
leaves: a 3-D MLP leaf (L, R, O) is taken per layer (its expert-batched
view: the dense MLP's, an MoE layer's shared experts'), every other leaf
is flattened over its reduction axes and every stack axis before them: wq
(L, d·H·hd), wo (L·H, hd·d); a routed-expert leaf (L, E, d, f) is one
(L, E·d·f) matrix, so its A is (L, r) and its B (r, E·d·f); a Mamba leaf
likewise (tiny_ssm's out (L, H, P, d): (L·H, P·d)), ``conv_w`` (L, K, ch)
as (L, K·ch); the hybrid's unstacked shared block as the 2-D leaves they
are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch import tree as T
from repro_torch.core.pruning.common import full_f32_matmul
from repro_torch.optim.optimizers import adamw, apply_updates, clip_by_global_norm
from repro_torch.sparsity import sparse_params as SP

Params = Any
_PER_LAYER = ("w_up", "w_gate", "w_down")


@dataclasses.dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    lr: float = 1e-4
    steps: int = 200
    batch: int = 8
    weight_decay: float = 0.0
    seed: int = 0


def _matrix(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """(R, O), or (L, R, O) for a 3-D MLP leaf: the reference's
    ``to_matrix`` of the stacked leaf."""
    if name in _PER_LAYER and leaf.dim() == 3:
        return leaf
    return SP.to_matrix(name, leaf)[0]


def _adapter(lora: Params, path) -> Optional[dict]:
    for n in path:
        if not isinstance(lora, dict) or n not in lora:
            return None
        lora = lora[n]
    return lora


def init_lora(params: Params, lcfg: LoRAConfig, generator: torch.Generator) -> Params:
    """A ~ N(0, 1/R) from ``generator`` (on its device, then moved to the
    leaf's), B = 0, so the delta starts at zero; a tree of ``{"A", "B"}``
    dicts at the prunable leaves' paths. The reference draws from
    ``jax.random``; the port does not reproduce its numbers."""
    out: dict = {}
    for names, w in T.leaves_with_path(params):
        if not SP.is_prunable(names, w):
            continue
        *E, R_, O = _matrix(names[-1], w).shape
        A = torch.randn((*E, R_, lcfg.rank), generator=generator, device=generator.device)
        T.set_path(out, names, {
            "A": (A / math.sqrt(R_)).to(torch.float32).to(w.device),
            "B": torch.zeros((*E, lcfg.rank, O), dtype=torch.float32, device=w.device),
        })
    return out


def merge(params: Params, masks: Params, lora: Params, lcfg: LoRAConfig) -> Params:
    """Effective params: the masked base plus the masked (α/r)·AB, summed in
    f32 in the reference's order and cast to the leaf's dtype."""
    scale = lcfg.alpha / lcfg.rank

    def g(path, w, m):
        ab = _adapter(lora, path)
        if ab is None or not SP.is_prunable(path, w):
            return w * m.to(w.dtype) if m.dim() else w
        mat = _matrix(path[-1], w)
        mf = _matrix(path[-1], m).to(torch.float32)
        delta = full_f32_matmul(ab["A"], ab["B"]) * scale
        return (mat.to(torch.float32) * mf + delta * mf).to(w.dtype).reshape(w.shape)

    return T.map_with_path(g, params, masks)


def finetune_lora(model, pruned_params: Params, masks: Params, data_iter: Iterator,
                  lcfg: Optional[LoRAConfig] = None,
                  extra_batch_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                  lora: Optional[Params] = None,
                  losses: Optional[List[torch.Tensor]] = None,
                  log: Optional[Callable[[str], None]] = None) -> Params:
    """Train adapters on the LM loss; returns the merged sparse params.

    The adapters start at ``lora`` (a tree as :func:`init_lora` makes, not
    written), by default :func:`init_lora` seeded with ``lcfg.seed`` on the
    params' device. ``data_iter`` yields (B, S) token arrays;
    ``extra_batch_fn(step)``, when given, the step's other batch arrays (a
    VLM's ``patches``, an encoder-decoder's ``frames``). ``losses``,
    when a list, gets each step's LM loss as a 0-d device tensor (no
    sync)."""
    lcfg = lcfg or LoRAConfig()
    device = pruned_params["embed"]["tok"].device
    if lora is None:
        lora = init_lora(pruned_params, lcfg,
                         torch.Generator(device=device).manual_seed(lcfg.seed))
    lora = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), lora)
    leaves = [t for _, t in T.leaves_with_path(lora)]
    opt = adamw(lcfg.lr, weight_decay=lcfg.weight_decay)
    state = opt.init(lora)
    for s in range(lcfg.steps):
        batch = {"tokens": torch.as_tensor(next(data_iter), device=device)}
        if extra_batch_fn:
            batch.update({k: torch.as_tensor(v, device=device)
                          for k, v in extra_batch_fn(s).items()})
        with torch.enable_grad():
            eff = merge(pruned_params, masks, lora, lcfg)
            loss, _ = model.loss(eff, batch, masks)
            grads = torch.autograd.grad(loss, leaves)
        del eff
        it = iter(grads)
        clipped, _ = clip_by_global_norm(T.tree_map(lambda _: next(it), lora), 1.0)
        updates, state = opt.update(clipped, state, lora)
        apply_updates(lora, updates)
        if losses is not None:
            losses.append(loss.detach())
        if log and s % max(1, lcfg.steps // 10) == 0:
            # obs: sync-ok (caller-requested logging, 1-in-10 cadence)
            log(f"lora step {s}: lm-loss {float(loss):.4f}")
    with torch.no_grad():
        return merge(pruned_params, masks, lora, lcfg)
