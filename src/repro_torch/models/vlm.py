"""LLaVA-NeXT-style VLM (port of ``repro.models.vlm``): the dense
transformer as the language backbone behind a stub vision frontend.

The frontend is a stub, as in the reference: the batch brings
precomputed patch embeddings ``patches`` (B, P, d), which go in front of
the token embeddings. The sequence is [patches ; text] at positions
``0 .. P + S_text - 1``, and the logits (and so the loss) cover the text
positions only. The parameter tree is the dense one (``init`` is the
transformer's: the stub has no weights), so ``interop`` needs nothing of
its own. Serving prefills the image prefix into the transformer's KV
cache with the text (``prefill_multimodal``) and decodes with the
transformer's ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

init = T.init
init_cache = T.init_cache
decode_step = T.decode_step


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          patches: torch.Tensor) -> torch.Tensor:
    """[patches ; token embeddings] (B, P + S_text, d) in the model's dtype.
    On a mesh both halves are brought to the batch layout first (a no-op
    without a policy): the token embedding of a vocab-sharded table is a
    sum over "model" until ``L.embed`` constrains it, and the patches come
    as the batch placed them."""
    dtype = T.torch_dtype(cfg.dtype)
    tok = L.embed(params["embed"]["tok"], tokens, dtype)
    return torch.cat([AS.constrain(patches.to(dtype), "bqd"), tok], dim=1)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, patches: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    """tokens (B, S_text), patches (B, P, d) -> logits (B, S_text, V) over
    the text positions. With ``masks`` every masked linear runs through
    the masked matmul kernel."""
    h = embed(params, cfg, tokens, patches)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h = L.apply_norm(params["final_norm"], T.run_blocks(params, cfg, h, positions, masks),
                     cfg.norm)
    return T.logits_from_hidden(params, cfg, h[:, patches.shape[1]:])


def prefill_multimodal(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       patches: torch.Tensor, cache: Params):
    """Prefill [patches ; text] into the cache at positions ``len .. len +
    P + S_text - 1``; returns (the last position's f32 logits (B, 1, V),
    the cache with ``len`` advanced by P + S_text). The cache is written in
    place, as ``transformer.prefill``'s."""
    return T.prefill_hidden(params, cfg, embed(params, cfg, tokens, patches), cache)


prefill = prefill_multimodal
