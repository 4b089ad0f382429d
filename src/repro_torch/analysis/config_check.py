"""Config arithmetic (the ``sharding`` pass's CFG rules; the port of
``repro.analysis.config_check.check_model_config``).

CFG001–007 check the pure config math, the ``d_model % num_heads == 0``
family of invariants, on the port's ``configs``. The reference's SHD001–005
run its sharding rules against a production mesh; they wait for the port's
distributed layer (ROADMAP.md A.8). Its HLO001–002 read post-SPMD HLO text,
which the port does not compile: they have no counterpart.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ModelConfig


def check_model_config(name: str, cfg: ModelConfig) -> List[Finding]:
    findings: List[Finding] = []

    def err(code, msg):
        findings.append(Finding(
            code=code, severity="error", pass_name="sharding",
            config=name, location="config", message=msg,
        ))

    if cfg.head_dim == 0 and cfg.num_heads > 0 and cfg.d_model % cfg.num_heads != 0:
        err("CFG001", f"d_model={cfg.d_model} not divisible by "
                      f"num_heads={cfg.num_heads} (and head_dim unset)")
    if cfg.num_kv_heads > 0 and cfg.num_heads % cfg.num_kv_heads != 0:
        err("CFG002", f"num_heads={cfg.num_heads} not divisible by "
                      f"num_kv_heads={cfg.num_kv_heads} (GQA grouping broken)")
    if cfg.family == "moe":
        if cfg.moe_top_k > cfg.moe_num_experts:
            err("CFG003", f"moe_top_k={cfg.moe_top_k} exceeds "
                          f"moe_num_experts={cfg.moe_num_experts}")
        if cfg.moe_d_ff <= 0:
            err("CFG003", "moe family requires moe_d_ff > 0")
        if cfg.moe_first_dense >= cfg.num_layers:
            err("CFG003", f"moe_first_dense={cfg.moe_first_dense} leaves no "
                          f"MoE layers (num_layers={cfg.num_layers})")
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_state <= 0:
            err("CFG004", f"{cfg.family} family requires ssm_state > 0")
        elif cfg.ssm_d_inner % cfg.ssm_head_dim != 0:
            err("CFG004", f"ssm_d_inner={cfg.ssm_d_inner} not divisible by "
                          f"ssm_head_dim={cfg.ssm_head_dim}")
    if cfg.family == "hybrid" and cfg.hybrid_attn_every <= 0:
        err("CFG005", "hybrid family requires hybrid_attn_every > 0")
    if cfg.family == "encdec" and cfg.enc_layers <= 0:
        err("CFG006", "encdec family requires enc_layers > 0")
    if cfg.vocab_size <= 0 or cfg.d_model <= 0 or cfg.num_layers <= 0:
        err("CFG007", "vocab_size, d_model, num_layers must be positive")
    return findings
