"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; shapes
(train/prefill/decode/long-context) are ``ShapeConfig``s. Configs are frozen
dataclasses so they can be closed over by jit'd functions safely.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned shapes (identical across LM-family archs).
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # ---- attention / block details ----
    qkv_bias: bool = False
    mlp_act: str = "swiglu"  # swiglu | sq_relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    attn_impl: str = "dot"  # dot | chunked | flash
    attn_chunk: int = 1024  # kv-chunk for chunked/flash attention
    attn_q_chunk: int = 0   # >0: block queries too (32k prefill memory)

    # ---- MoE ----
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    moe_first_dense: int = 0  # leading dense layers (DeepSeek/Kimi style)
    moe_capacity_factor: float = 1.25
    # dispatch groups: tokens are routed within G independent groups with
    # per-group capacity. Set G = data-parallel shards at scale so the
    # (G, E, C, d) dispatch buffer shards as (data, model/EP, ., .) with
    # *local* capacity — the global-capacity buffer would be O(total
    # tokens) per device. G=1 reproduces plain global dispatch.
    moe_dispatch_groups: int = 1

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # ---- hybrid (Zamba2) ----
    hybrid_attn_every: int = 0  # apply the shared attention block every k layers

    # ---- enc-dec (Seamless-M4T) ----
    enc_layers: int = 0  # when >0, num_layers is the decoder depth

    # ---- modality frontends (stubs per assignment) ----
    frontend: str = "none"  # none | vision | audio
    frontend_len: int = 0  # patch / frame count supplied by input_specs()

    # ---- numerics ----
    dtype: str = "float32"  # activation/compute dtype
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 128
    remat: str = "none"  # none | block
    # scan group size for hybrid models
    max_position: int = 524288

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic families run long_500k; full-attention archs skip it."""
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> Tuple[ShapeConfig, ...]:
        """The assigned shape cells applicable to this arch."""
        out = []
        for s in ALL_SHAPES:
            if s.name == "long_500k" and not self.supports_long_context:
                continue
            out.append(s)
        return tuple(out)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for MODEL_FLOPS = 6*N*D roofline accounting).
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        V = self.padded_vocab

        def attn_params() -> int:
            p = d * hd * (h + 2 * kv) + h * hd * d
            if self.qkv_bias:
                p += hd * (h + 2 * kv)
            return p

        def dense_mlp(ff: int) -> int:
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * d * ff

        if self.family == "ssm":
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
            per_layer = (
                d * (2 * di + 2 * N + H)  # in_proj (z, x, B, C, dt)
                + self.ssm_conv * (di + 2 * N)  # conv
                + di * d  # out_proj
                + 3 * H  # A_log, D, dt_bias
                + di  # gated norm
            )
            body = self.num_layers * (per_layer + d)
        elif self.family == "hybrid":
            di, N, H = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
            mamba = (
                d * (2 * di + 2 * N + H)
                + self.ssm_conv * (di + 2 * N)
                + di * d
                + 3 * H
                + di
                + d
            )
            shared = attn_params() + dense_mlp(self.d_ff) + 2 * d
            body = self.num_layers * mamba + shared
        elif self.family == "moe":
            n_moe = self.num_layers - self.moe_first_dense
            k = self.moe_top_k if active_only else self.moe_num_experts
            per_moe = (
                attn_params()
                + d * self.moe_num_experts  # router (always active)
                + (k + self.moe_num_shared) * dense_mlp(self.moe_d_ff) // 1
                + 2 * d
            )
            per_dense = attn_params() + dense_mlp(self.d_ff) + 2 * d
            body = n_moe * per_moe + self.moe_first_dense * per_dense
        elif self.family == "encdec":
            enc = self.enc_layers * (attn_params() + dense_mlp(self.d_ff) + 2 * d)
            dec = self.num_layers * (
                2 * attn_params() + dense_mlp(self.d_ff) + 3 * d
            )
            body = enc + dec
        else:  # dense | vlm
            body = self.num_layers * (attn_params() + dense_mlp(self.d_ff) + 2 * d)

        embed = V * d * (1 if self.tie_embeddings else 2)
        return body + embed + d  # + final norm
