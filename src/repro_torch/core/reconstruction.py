"""Block-wise reconstruction machinery (port of
``repro.core.reconstruction``, every family): the execution plan, the
stream advances, and the EBFT objective for block l (paper Eq. 4)

    min_{W̄_l}  || z^l  −  z̄^l ||₂²

where z^l is the dense teacher's block output and z̄^l the sparse
student's, computed from the student's own stream (Eq. 3). A segment's
``aux`` (the encoder-decoder's encoder memory) is passed to every block
of the segment as keyword arguments of ``apply_block``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import encdec as ED
from repro_torch.models.transformer import torch_dtype

Params = Any


@dataclasses.dataclass
class Segment:
    """A contiguous stretch of the model sharing one hidden stream."""

    visits: List[Tuple[int, int]]  # (block_index, site_id) in execution order
    h0: Callable[[Params, Dict], Tuple[torch.Tensor, torch.Tensor]]  # -> (h, positions)
    # (params, batch, masks=None) -> the blocks' keyword arguments, e.g. the
    # encoder memory; None for a segment whose blocks take none
    aux: Optional[Callable[..., Dict[str, torch.Tensor]]] = None


def execution_plan(model) -> List[Segment]:
    """The dense, VLM, MoE and SSM families: one segment that visits every
    block once (an MoE stack's leading dense blocks first). The hybrid: one
    segment that visits, for each group g, its K Mamba blocks and then the
    shared block (index ``num_blocks - 1``) as site g, then the trailing
    Mamba blocks. The encoder-decoder: the encoder's segment, from the
    frames in the model's dtype at positions ``0 .. F - 1``, then the
    decoder's, from the token embeddings, with ``aux`` the memory that the
    given params (and masks) encode."""
    cfg = model.cfg
    if cfg.family == "encdec":
        def enc_h0(params, batch):
            frames = batch["frames"].to(torch_dtype(cfg.dtype))
            return frames, torch.arange(frames.shape[1], device=frames.device)[None, :]

        def dec_aux(params, batch, masks=None):
            return {"memory": ED.encode(params, cfg, batch["frames"], masks)}

        n_enc = cfg.enc_layers
        return [Segment([(i, 0) for i in range(n_enc)], enc_h0),
                Segment([(i, 0) for i in range(n_enc, model.num_blocks)], model.embed_tokens,
                        dec_aux)]
    if cfg.family == "hybrid":
        K = cfg.hybrid_attn_every
        G = cfg.num_layers // K
        shared = model.num_blocks - 1
        visits: List[Tuple[int, int]] = []
        for g in range(G):
            visits += [(g * K + j, 0) for j in range(K)]
            visits.append((shared, g))
        visits += [(i, 0) for i in range(G * K, cfg.num_layers)]
        return [Segment(visits, model.embed_tokens)]
    return [Segment([(i, 0) for i in range(model.num_blocks)], model.embed_tokens)]


def advance(model, params, i: int, h, positions, masks: Optional[Params] = None,
            aux: Optional[Dict] = None):
    """Apply block ``i`` with its own stored weights (and block masks)."""
    bp = model.get_block(params, i)
    return model.apply_block(params, i, bp, h, positions, masks, **(aux or {}))


def advance_with(model, params, i: int, bp, h, positions, masks: Optional[Params] = None,
                 aux: Optional[Dict] = None):
    """Apply block ``i`` with explicit block weights ``bp``."""
    return model.apply_block(params, i, bp, h, positions, masks, **(aux or {}))


def block_kind(model, i: int) -> str:
    """Blocks of one kind behave alike: the dense (and VLM) and SSM
    families have one kind each, the MoE family ``"dense"`` (its leading dense blocks) and
    ``"moe"``, the hybrid ``"mamba"`` and ``"shared"``, the encoder-decoder
    ``"enc"`` and ``"dec"``."""
    cfg = model.cfg
    if cfg.family == "moe":
        return "dense" if i < cfg.moe_first_dense else "moe"
    if cfg.family == "hybrid":
        return "shared" if i == model.num_blocks - 1 else "mamba"
    if cfg.family == "encdec":
        return "enc" if i < cfg.enc_layers else "dec"
    return "block"


def _masked_out(model, i: int, bw, masks_b, h_in, positions, aux) -> torch.Tensor:
    """The block's output with W̄ = M ⊙ W: each masked linear runs through
    the masked matmul (``MaskedMatmulFn`` under grad), the same function as
    the reference's ``apply_masks`` + einsum without a weight-sized copy."""
    return model.apply_block(None, i, bw, h_in, positions, masks_b, **(aux or {}))


def block_loss(model, i: int, bw, masks_b, h_in, target, positions,
               aux: Optional[Dict] = None) -> torch.Tensor:
    """Eq. 4: mean-squared block-output reconstruction error for block i.

    ``bw`` are the block's trainable weights; ``masks_b`` the block's frozen
    masks; ``aux`` the segment's keyword arguments (the encoder memory).
    ``out - target`` is taken in the block's dtype and only then upcast to
    f32, as the reference. Mean (not sum) keeps lr scale-free."""
    err = (_masked_out(model, i, bw, masks_b, h_in, positions, aux) - target).float()
    return torch.mean(torch.square(err))


def reconstruction_error(model, i: int, bw, masks_b, h_in, target, positions,
                         aux: Optional[Dict] = None) -> torch.Tensor:
    """Reported metric: relative block error ‖z−z̄‖₂ / ‖z‖₂."""
    out = _masked_out(model, i, bw, masks_b, h_in, positions, aux)
    num = torch.linalg.vector_norm((out - target).float())
    den = torch.clamp_min(torch.linalg.vector_norm(target.float()), 1e-9)
    return num / den
