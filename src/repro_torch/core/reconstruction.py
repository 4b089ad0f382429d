"""Block-wise execution plan and stream advances (port of the forward
parts of ``repro.core.reconstruction``; the EBFT loss comes with the
tuning slice)."""
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
            f"execution plan for family {model.cfg.family!r} (ROADMAP.md queue A.9)")
    return [Segment([(i, 0) for i in range(model.num_blocks)], model.embed_tokens)]


def advance(model, params, i: int, h, positions, masks: Optional[Params] = None):
    """Apply block ``i`` with its own stored weights (and block masks)."""
    bp = model.get_block(params, i)
    return model.apply_block(params, i, bp, h, positions, masks)


def advance_with(model, params, i: int, bp, h, positions, masks: Optional[Params] = None):
    """Apply block ``i`` with explicit block weights ``bp``."""
    return model.apply_block(params, i, bp, h, positions, masks)
