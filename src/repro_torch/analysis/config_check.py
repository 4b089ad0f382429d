"""Config arithmetic and sharding validation (the ``sharding`` pass; the
port of ``repro.analysis.config_check``).

CFG001–007 check the pure config math, the ``d_model % num_heads == 0``
family of invariants, on the port's ``configs``. SHD001–004 run the
port's sharding rules (``distributed.sharding.param_pspecs``) on the
real parameter shapes against the production 16 × 16 mesh and check
every spec leaf by leaf: its axes must exist in the mesh and divide their
dimension. SHD005 runs the EBFT walk's ``MeshPlan`` on a (data, model)
mesh and reports the layouts that fall back to replication. Shapes come
from an init under ``FakeTensorMode`` (``sharding.abstract_params``):
nothing is allocated, not even for Kimi-K2. The reference's HLO001–002
read post-SPMD HLO text, which the port does not compile: they have no
counterpart.
"""
from __future__ import annotations

from typing import List

from repro_torch import tree as T
from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.launch.mesh import abstract_production_mesh, make_abstract_mesh


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


# ---------------------------------------------------------------------------
def check_sharding(name: str, cfg: ModelConfig, *, multi_pod: bool = False) -> List[Finding]:
    """Run the sharding rules on the real parameter shapes and verify the
    emitted specs against the production mesh."""
    from repro_torch.models.model import build

    findings: List[Finding] = []
    mesh = abstract_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    try:
        shapes = SH.abstract_params(build(cfg))
    except Exception as e:  # a config too broken to build
        findings.append(Finding(
            code="SHD000", severity="error", pass_name="sharding",
            config=name, location="build",
            message=f"model build/abstract init failed: {e}",
        ))
        return findings

    specs = SH.param_pspecs(shapes, mesh, fsdp=False)
    names = set(mesh.axis_names)

    def visit(path, leaf, spec):
        loc = "/".join(path)
        for d, ax in enumerate(spec):
            size = 1
            for a in SH.spec_axes(ax):
                if a not in names:
                    findings.append(Finding(
                        code="SHD001", severity="error", pass_name="sharding",
                        config=name, location=f"{loc}[{d}]",
                        message=f"spec axis {a!r} not in mesh {mesh_name} {sorted(names)}",
                    ))
                size *= SH.mesh_axis_size(mesh, a)
            if size > 1 and leaf.shape[d] % size != 0:
                findings.append(Finding(
                    code="SHD002", severity="error", pass_name="sharding",
                    config=name, location=f"{loc}[{d}]",
                    message=f"dim {leaf.shape[d]} not divisible by mesh extent {size} ({ax})",
                ))
        return leaf

    T.map_with_path(visit, shapes, specs)

    msize = SH.mesh_axis_size(mesh, SH.MODEL_AXIS)
    if cfg.num_heads > 0 and cfg.num_heads % msize != 0:
        findings.append(Finding(
            code="SHD003", severity="warn", pass_name="sharding",
            config=name, location="attention",
            message=f"num_heads={cfg.num_heads} not divisible by model axis {msize}: falls "
                    "back to zero-padded head expansion (launch/steps.py padded_heads)",
        ))
    if 0 < cfg.num_kv_heads < msize:
        findings.append(Finding(
            code="SHD004", severity="info", pass_name="sharding",
            config=name, location="attention",
            message=f"num_kv_heads={cfg.num_kv_heads} < model axis {msize}: KV projections "
                    "replicate (standard Megatron GQA fallback)",
        ))
    return findings


def check_ebft_mesh_plan(name: str, cfg: ModelConfig, *, data: int = 16, model_axis: int = 16,
                         microbatch: int = 256, seq: int = 1024) -> List[Finding]:
    """Verify that the EBFT walk's layouts divide the mesh (SHD005). The
    plan never fails at run time (a leaf that does not divide replicates),
    so this pass is where the fallback shows: a warn per degraded layout.
    The production values (16 × 16, microbatch 256) divide cleanly."""
    from repro_torch.models.model import build

    findings: List[Finding] = []
    plan = MeshPlan.from_mesh(make_abstract_mesh((data, model_axis), ("data", "model")))

    # the streams: each microbatch's batch dim over "data"
    if plan.data_size > 1 and microbatch % plan.data_size != 0:
        findings.append(Finding(
            code="SHD005", severity="warn", pass_name="sharding",
            config=name, location="ebft.stacked_stream",
            message=f"microbatch={microbatch} not divisible by data axis {plan.data_size}: "
                    "calibration streams replicate (MeshPlan.stacked_spec fallback: every "
                    "device holds the full batch)",
        ))

    # the block's weights over "model": a matrix leaf that fell back to full
    # replication loses the one-live-block-shard-per-device property
    try:
        block0 = SH.abstract_params(build(cfg), block=0)
    except Exception as e:
        findings.append(Finding(
            code="SHD000", severity="error", pass_name="sharding",
            config=name, location="ebft.build",
            message=f"model build/abstract init failed: {e}",
        ))
        return findings

    leaves = {"/".join(p): leaf for p, leaf in T.leaves_with_path(block0)}
    # a unit mesh passes every divisibility check, so a leaf sharded there
    # and replicated on the real mesh is exactly the divisibility fallback;
    # leaves unsharded on both have no rule and replicate by design
    unit = MeshPlan.from_mesh(make_abstract_mesh((1, 1), ("data", "model")))
    rule_exists = {p: sharded for p, _spec, sharded in unit.explain(block0)}
    degraded = []
    # in jax's sorted-key leaf order, as the reference lists them
    for path, _spec, sharded in sorted(plan.explain(block0), key=lambda e: e[0].split("/")):
        leaf = leaves.get(path)
        if leaf is None or len(leaf.shape) < 2:
            continue  # biases and norms replicate by design
        if not sharded and rule_exists.get(path):
            degraded.append(f"{path}{tuple(leaf.shape)}")
    if degraded:
        shown = ", ".join(degraded[:4])
        more = f" (+{len(degraded) - 4} more)" if len(degraded) > 4 else ""
        findings.append(Finding(
            code="SHD005", severity="warn", pass_name="sharding",
            config=name, location="ebft.block0",
            message=f"{len(degraded)} block leaves replicate on the {data}x{model_axis} mesh "
                    "(param_pspecs divisibility fallback; per-shard live-block bytes = full "
                    f"leaf): {shown}{more}",
        ))
    return findings
