"""Block-wise reconstruction machinery (port of
``repro.core.reconstruction``, dense family): the execution plan, the
stream advances, and the EBFT objective for block l (paper Eq. 4)

    min_{W̄_l}  || z^l  −  z̄^l ||₂²

where z^l is the dense teacher's block output and z̄^l the sparse
student's, computed from the student's own stream (Eq. 3)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Params = Any


@dataclasses.dataclass
class Segment:
    """A contiguous stretch of the model sharing one hidden stream."""

    visits: List[Tuple[int, int]]  # (block_index, site_id) in execution order
    h0: Callable[[Params, Dict], Tuple[torch.Tensor, torch.Tensor]]  # -> (h, positions)


def execution_plan(model) -> List[Segment]:
    """The dense family's plan: one segment visiting every block once."""
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"execution plan for family {model.cfg.family!r} (ROADMAP.md queue A.5)")
    return [Segment([(i, 0) for i in range(model.num_blocks)], model.embed_tokens)]


def advance(model, params, i: int, h, positions, masks: Optional[Params] = None):
    """Apply block ``i`` with its own stored weights (and block masks)."""
    bp = model.get_block(params, i)
    return model.apply_block(params, i, bp, h, positions, masks)


def advance_with(model, params, i: int, bp, h, positions, masks: Optional[Params] = None):
    """Apply block ``i`` with explicit block weights ``bp``."""
    return model.apply_block(params, i, bp, h, positions, masks)


def block_kind(model, i: int) -> str:
    """Blocks of one kind behave alike; the dense family has one kind."""
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"block kinds of family {model.cfg.family!r} (ROADMAP.md queue A.5)")
    return "block"


def _masked_out(model, i: int, bw, masks_b, h_in, positions) -> torch.Tensor:
    """The block's output with W̄ = M ⊙ W: each masked linear runs through
    the masked matmul (``MaskedMatmulFn`` under grad), the same function as
    the reference's ``apply_masks`` + einsum without a weight-sized copy."""
    return model.apply_block(None, i, bw, h_in, positions, masks_b)


def block_loss(model, i: int, bw, masks_b, h_in, target, positions) -> torch.Tensor:
    """Eq. 4: mean-squared block-output reconstruction error for block i.

    ``bw`` are the block's trainable weights; ``masks_b`` the block's frozen
    masks. ``out - target`` is taken in the block's dtype and only then
    upcast to f32, as the reference. Mean (not sum) keeps lr scale-free."""
    err = (_masked_out(model, i, bw, masks_b, h_in, positions) - target).float()
    return torch.mean(torch.square(err))


def reconstruction_error(model, i: int, bw, masks_b, h_in, target, positions) -> torch.Tensor:
    """Reported metric: relative block error ‖z−z̄‖₂ / ‖z‖₂."""
    out = _masked_out(model, i, bw, masks_b, h_in, positions)
    num = torch.linalg.vector_norm((out - target).float())
    den = torch.clamp_min(torch.linalg.vector_norm(target.float()), 1e-9)
    return num / den
