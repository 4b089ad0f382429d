"""Model facade (port of ``repro.models.model``: the dense, MoE, SSM,
hybrid, VLM and encoder-decoder families).

``build(cfg)`` returns a ``Model`` with the reference's interface:

    m.init(generator)                         -> params on generator.device
    m.loss(params, batch, masks=None)         -> (scalar loss, metrics dict)
    m.forward(params, batch, masks=None)      -> logits
    m.init_serve_state(batch, max_len, device=None) -> KV cache (None: the card)
    m.prefill(params, batch, state)           -> (last logits, state)
    m.decode_step(params, token, state)       -> (logits, state)
    m.input_specs(shape)                      -> {batch key: TensorSpec}

plus the block-level API the calibration walk uses:

    m.num_blocks
    m.get_block(params, i) / m.set_block(params, i, bp)
    m.apply_block(params, i, bp, h, positions, masks=None, **aux) -> h'
    m.embed_tokens(params, batch) -> (h0, positions)
    m.finalize(params, h) -> logits

``get_block`` returns views into the stacked leaves; ``set_block`` copies
the block into them in place (the reference returns a new tree; the port
saves a copy of the whole model per block and returns the same tree). In
the MoE family blocks ``0 .. moe_first_dense - 1`` are the dense blocks and
the rest the MoE blocks; its loss is ``nll + 0.01·aux`` (the load-balance
term) with the metrics ``{"nll", "aux"}``. In the hybrid family blocks
``0 .. num_layers - 1`` are the Mamba blocks in execution order and block
``num_layers`` the shared attention block, whose ``get_block`` is the
live ``params["shared"]`` tree (counted once in ``num_blocks``). The VLM
is the dense model over [patches ; text]: its batch also holds
``patches`` (B, P, d), its loss and ``forward`` cover the text positions,
and ``embed_tokens``/``finalize`` the whole multimodal stream, as the
reference's. In the encoder-decoder family the batch also holds
``frames`` (B, F, d) with F = max(frontend_len, S // 8); blocks ``0 ..
enc_layers - 1`` are the encoder's and the rest the decoder's, whose
``apply_block`` takes the encoder ``memory=`` (the walk's segment
``aux``); ``embed_tokens`` and ``finalize`` are the decoder's, and the
serve state is ``{"cache", "memory"}``, the memory encoded at prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, layers, moe, ssm, transformer, vlm

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


class TensorSpec(NamedTuple):
    """A batch entry's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _token_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    return {"tokens": TensorSpec((shape.global_batch, shape.seq_len), torch.int32)}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_serve_state: Callable
    prefill: Callable
    decode_step: Callable
    input_specs: Callable  # (ShapeConfig) -> {batch key: TensorSpec}
    num_blocks: int
    get_block: Callable
    set_block: Callable
    apply_block: Callable
    embed_tokens: Callable
    finalize: Callable


def _set_tree(tree: Params, i, sub: Params) -> None:
    """Copy ``sub`` into ``tree[.][i]`` in place (``i`` an index, a tuple of
    indices, or ``...`` for an unstacked tree)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_tree(v, i, sub[k])
        else:
            v[i].copy_(sub[k])


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "dense":
        return _build_dense(cfg)
    if cfg.family == "moe":
        return _build_moe(cfg)
    if cfg.family == "ssm":
        return _build_ssm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "vlm":
        return _build_vlm(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A.5)")


def _embed_tokens(cfg: ModelConfig):
    def embed_tokens(params, batch):
        tokens = batch["tokens"]
        h = layers.embed(params["embed"]["tok"], tokens, transformer.torch_dtype(cfg.dtype))
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return h, pos

    return embed_tokens


def _finalize(cfg: ModelConfig):
    def finalize(params, h):
        h = layers.apply_norm(params["final_norm"], h, cfg.norm)
        return transformer.logits_from_hidden(params, cfg, h)

    return finalize


def _nll_loss(forward):
    """The loss of every family but the MoE: the next-token NLL of
    ``forward``'s logits, also its one metric ``{"nll"}``."""
    def loss(params, batch, masks=None):
        l = _shift_loss(forward(params, batch, masks), batch["tokens"])
        return l, {"nll": l}

    return loss


def _serving(M, cfg: ModelConfig) -> Dict[str, Callable]:
    """A model module's cache entries (``init_cache``, ``prefill``,
    ``decode_step``) as the ``Model`` fields; the cache on the card unless
    ``device`` says otherwise. Also the token-only ``input_specs``."""
    return dict(
        input_specs=lambda shape: _token_specs(cfg, shape),
        init_serve_state=lambda b, ml, device=None: M.init_cache(cfg, b, ml,
                                                                 resolve_device(device)),
        prefill=lambda params, batch, state: M.prefill(params, cfg, batch["tokens"], state),
        decode_step=lambda params, token, state: M.decode_step(params, cfg, token, state),
    )


def _build_dense(cfg: ModelConfig) -> Model:
    M = transformer

    def forward(params, batch, masks=None):
        return M.forward(params, cfg, batch["tokens"], masks=masks)

    def apply_block(params, i, bp, h, positions, masks=None):
        return M.block_apply(bp, cfg, h, positions, masks)

    def set_block(params, i, bp):
        _set_tree(params["blocks"], i, bp)
        return params

    return Model(
        cfg=cfg,
        init=lambda g: M.init(g, cfg),
        forward=forward,
        loss=_nll_loss(forward),
        **_serving(M, cfg),
        num_blocks=cfg.num_layers,
        get_block=lambda params, i: M.slice_block(params["blocks"], i),
        set_block=set_block,
        apply_block=apply_block,
        embed_tokens=_embed_tokens(cfg),
        finalize=_finalize(cfg),
    )


def _build_moe(cfg: ModelConfig) -> Model:
    n_dense = cfg.moe_first_dense

    def forward(params, batch, masks=None):
        return moe.forward(params, cfg, batch["tokens"], masks)

    def loss(params, batch, masks=None):
        h, aux = moe.forward_hidden(params, cfg, batch["tokens"], masks)
        nll = _shift_loss(transformer.logits_from_hidden(params, cfg, h), batch["tokens"])
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def group(i):
        return ("dense_blocks", i) if i < n_dense else ("moe_blocks", i - n_dense)

    def get_block(params, i):
        name, j = group(i)
        return transformer.slice_block(params[name], j)

    def set_block(params, i, bp):
        name, j = group(i)
        _set_tree(params[name], j, bp)
        return params

    def apply_block(params, i, bp, h, positions, masks=None):
        if i < n_dense:
            return transformer.block_apply(bp, cfg, h, positions, masks)
        return moe.moe_block_apply(bp, cfg, h, positions, masks)[0]

    return Model(
        cfg=cfg,
        init=lambda g: moe.init(g, cfg),
        forward=forward,
        loss=loss,
        **_serving(moe, cfg),
        num_blocks=cfg.num_layers,
        get_block=get_block,
        set_block=set_block,
        apply_block=apply_block,
        embed_tokens=_embed_tokens(cfg),
        finalize=_finalize(cfg),
    )


def _build_ssm(cfg: ModelConfig) -> Model:
    def forward(params, batch, masks=None):
        return ssm.forward(params, cfg, batch["tokens"], masks)

    def set_block(params, i, bp):
        _set_tree(params["blocks"], i, bp)
        return params

    return Model(
        cfg=cfg,
        init=lambda g: ssm.init(g, cfg),
        forward=forward,
        loss=_nll_loss(forward),
        **_serving(ssm, cfg),
        num_blocks=cfg.num_layers,
        get_block=lambda params, i: transformer.slice_block(params["blocks"], i),
        set_block=set_block,
        apply_block=lambda params, i, bp, h, positions, masks=None: ssm.mamba_block_apply(
            bp, cfg, h, masks=masks)[0],
        embed_tokens=_embed_tokens(cfg),
        finalize=_finalize(cfg),
    )


def _build_hybrid(cfg: ModelConfig) -> Model:
    G, K, _ = hybrid.schedule(cfg)
    n_mamba = cfg.num_layers  # block n_mamba is the shared block

    def forward(params, batch, masks=None):
        return hybrid.forward(params, cfg, batch["tokens"], masks)

    def get_block(params, i):
        return params["shared"] if i == n_mamba else hybrid.mamba_block(params, i, cfg)

    def set_block(params, i, bp):
        if i == n_mamba:
            _set_tree(params["shared"], ..., bp)
        elif i < G * K:
            _set_tree(params["groups"], (i // K, i % K), bp)
        else:
            _set_tree(params["trailing"], i - G * K, bp)
        return params

    def apply_block(params, i, bp, h, positions, masks=None):
        if i == n_mamba:
            return transformer.block_apply(bp, cfg, h, positions, masks)
        return ssm.mamba_block_apply(bp, cfg, h, masks=masks)[0]

    return Model(
        cfg=cfg,
        init=lambda g: hybrid.init(g, cfg),
        forward=forward,
        loss=_nll_loss(forward),
        **_serving(hybrid, cfg),
        num_blocks=n_mamba + 1,
        get_block=get_block,
        set_block=set_block,
        apply_block=apply_block,
        embed_tokens=_embed_tokens(cfg),
        finalize=_finalize(cfg),
    )


def _build_vlm(cfg: ModelConfig) -> Model:
    """The dense model's blocks, cache and ``finalize``, over [patches ; text]."""
    def forward(params, batch, masks=None):
        return vlm.forward(params, cfg, batch["tokens"], batch["patches"], masks)

    def input_specs(shape: ShapeConfig) -> Dict[str, TensorSpec]:
        B, S = shape.global_batch, shape.seq_len
        P = min(cfg.frontend_len, S // 2)
        return {"tokens": TensorSpec((B, S - P), torch.int32),
                "patches": TensorSpec((B, P, cfg.d_model), transformer.torch_dtype(cfg.dtype))}

    def embed_tokens(params, batch):
        h = vlm.embed(params, cfg, batch["tokens"], batch["patches"])
        return h, torch.arange(h.shape[1], device=h.device)[None, :]

    return dataclasses.replace(
        _build_dense(cfg), init=lambda g: vlm.init(g, cfg), forward=forward,
        loss=_nll_loss(forward), input_specs=input_specs, embed_tokens=embed_tokens,
        prefill=lambda params, batch, state: vlm.prefill_multimodal(
            params, cfg, batch["tokens"], batch["patches"], state))


def _build_encdec(cfg: ModelConfig) -> Model:
    """Encoder blocks ``[0, n_enc)``, decoder blocks ``[n_enc, n_enc +
    n_dec)``; the loss is the next-token NLL over the decoder's tokens."""
    M = encdec
    n_enc = cfg.enc_layers
    dtype = transformer.torch_dtype(cfg.dtype)

    def forward(params, batch, masks=None):
        return M.forward(params, cfg, batch["tokens"], batch["frames"], masks)

    def input_specs(shape: ShapeConfig) -> Dict[str, TensorSpec]:
        B, S = shape.global_batch, shape.seq_len
        F = max(cfg.frontend_len, S // 8)
        return {"tokens": TensorSpec((B, S), torch.int32),
                "frames": TensorSpec((B, F, cfg.d_model), dtype)}

    def init_serve_state(b, ml, device=None):
        device = resolve_device(device)
        F = max(cfg.frontend_len, ml // 8)
        return {"cache": M.init_cache(cfg, b, ml, device),
                "memory": torch.zeros((b, F, cfg.d_model), dtype=dtype, device=device)}

    def prefill(params, batch, state):
        memory = M.encode(params, cfg, batch["frames"])
        logits, cache = M.prefill(params, cfg, batch["tokens"], state["cache"], memory)
        return logits, {"cache": cache, "memory": memory}

    def decode_step(params, token, state):
        logits, cache = M.decode_step(params, cfg, token, state["cache"], state["memory"])
        return logits, {"cache": cache, "memory": state["memory"]}

    def group(i):
        return ("enc_blocks", i) if i < n_enc else ("dec_blocks", i - n_enc)

    def get_block(params, i):
        name, j = group(i)
        return transformer.slice_block(params[name], j)

    def set_block(params, i, bp):
        name, j = group(i)
        _set_tree(params[name], j, bp)
        return params

    def apply_block(params, i, bp, h, positions, masks=None, memory=None):
        if i < n_enc:
            return M.enc_block_apply(bp, cfg, h, positions, masks)
        return M.dec_block_apply(bp, cfg, h, memory, positions, masks)

    return Model(
        cfg=cfg,
        init=lambda g: M.init(g, cfg),
        forward=forward,
        loss=_nll_loss(forward),
        init_serve_state=init_serve_state,
        prefill=prefill,
        decode_step=decode_step,
        input_specs=input_specs,
        num_blocks=n_enc + cfg.num_layers,
        get_block=get_block,
        set_block=set_block,
        apply_block=apply_block,
        embed_tokens=_embed_tokens(cfg),
        finalize=_finalize(cfg),
    )
