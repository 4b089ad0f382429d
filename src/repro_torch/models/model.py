"""Model facade (port of ``repro.models.model``, dense family only).

``build(cfg)`` returns a ``Model`` with the reference's interface:

    m.init(generator)                         -> params on generator.device
    m.loss(params, batch, masks=None)         -> (scalar loss, metrics dict)
    m.forward(params, batch, masks=None)      -> logits

plus the block-level API the calibration walk uses:

    m.num_blocks
    m.get_block(params, i) / m.set_block(params, i, bp)
    m.apply_block(params, i, bp, h, positions, masks=None) -> h'
    m.embed_tokens(params, batch) -> (h0, positions)
    m.finalize(params, h) -> logits

``get_block`` returns views into the stacked leaves; ``set_block`` copies
the block into them in place (the reference returns a new tree; the port
saves a copy of the whole model per block and returns the same tree).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer

Params = Dict[str, Any]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V), labels (B,S). Mean NLL over ``mask``, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _shift_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss: predict tokens[:, 1:] from logits[:, :-1]."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    num_blocks: int
    get_block: Callable
    set_block: Callable
    apply_block: Callable
    embed_tokens: Callable
    finalize: Callable


def _set_tree(tree: Params, i: int, sub: Params) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_tree(v, i, sub[k])
        else:
            v[i].copy_(sub[k])


def build(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A.5)")
    return _build_dense(cfg)


def _build_dense(cfg: ModelConfig) -> Model:
    M = transformer

    def forward(params, batch, masks=None):
        return M.forward(params, cfg, batch["tokens"], masks=masks)

    def loss(params, batch, masks=None):
        l = _shift_loss(forward(params, batch, masks), batch["tokens"])
        return l, {"nll": l}

    def embed_tokens(params, batch):
        tokens = batch["tokens"]
        h = layers.embed(params["embed"]["tok"], tokens, M.torch_dtype(cfg.dtype))
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return h, pos

    def apply_block(params, i, bp, h, positions, masks=None):
        return M.block_apply(bp, cfg, h, positions, masks)

    def finalize(params, h):
        h = layers.apply_norm(params["final_norm"], h, cfg.norm)
        return M.logits_from_hidden(params, cfg, h)

    def set_block(params, i, bp):
        _set_tree(params["blocks"], i, bp)
        return params

    return Model(
        cfg=cfg,
        init=lambda g: M.init(g, cfg),
        forward=forward,
        loss=loss,
        num_blocks=cfg.num_layers,
        get_block=lambda params, i: M.slice_block(params["blocks"], i),
        set_block=set_block,
        apply_block=apply_block,
        embed_tokens=embed_tokens,
        finalize=finalize,
    )
