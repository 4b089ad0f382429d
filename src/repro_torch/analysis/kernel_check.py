"""Kernel launch validation, statically, per config (the port of
``repro.analysis.kernel_check``).

For every config this enumerates the launches its EBFT walk and its
serving make, at the config's full widths, and builds each one's
:class:`~repro_torch.kernels.validation.KernelPlan` through the SAME
builders the wrappers launch through:

  * ``tuning.ebft_workloads(cfg, 8 * 1024, 1024, pattern=(2, 4))``: the
    masked products (forward, dX, dW; the routed experts' batched ones),
    ``nm_spmm`` at 2:4 and the attention forward of a walk over the
    reference's 8 x 1024 calibration tokens, and the attention backward
    at the same shapes;
  * the attention forward of each ``cfg.shapes()`` entry, B x H rows: a
    decode step is Sq 1 against Sk keys at ``q_offset`` Sk - 1, the others
    Sq = Sk.

Each launch is planned in bf16, which the card runs, and in the config's
own dtype, with the default tiles an ``off`` run launches; masks in the
layout ``masked_matmul.ops.aligned_mask`` gives them (rows 16 bytes apart).
The codes, with their Hopper meanings:

  * KER001 (error) the builder refuses a launch the port makes: the
    wrapper would raise on the card;
  * KER002 (error) dynamic shared memory above a block's ``SMEM_MAX``;
  * KER003 (error) a tensor map's problem (``TmaMap.problems``), or a
    grid y or z above 65535;
  * KER004 (info)  a ring shallower than its kernel's designed depth (4
    GEMM stages; the attention forward's ``ATTN_RING_KEYS`` keys; the
    backward's 2): the main loop has less latency to hide behind. The
    reference's "VMEM above 50% of budget" has no Hopper meaning: the
    4-stage GEMM ring fills the block's shared memory by design;
  * KER005 (warn)  N:M compression unavailable for a leaf: K is not a
    multiple of M, or ``plan_nm_spmm`` refuses the layout (an idx whose
    rows are not 16 bytes apart) — the masked product still serves it.

KER002 and KER003 are what a built plan is checked for; the builders
already refuse both, so on shipped configs they can only come from a plan
made some other way.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import tuning
from repro_torch.kernels import validation as V
from repro_torch.kernels.validation import KernelPlan

TUNE_TOKENS = 8 * 1024   # the reference's EBFT microbatch: 8 x 1024-token segments
CALIB_SEQ = 1024
NM = (2, 4)

# (location, route, build) of one launch
Launch = Tuple[str, str, Callable[[], KernelPlan]]


def mask_operands(route: str, dims: Dict[str, int], aligned: bool = True):
    """The (strides, address) of a masked route's three operands as the
    wrapper hands them over: contiguous, the mask's rows ``aligned_mask``'s
    multiple of 16 bytes apart (or contiguous too, with ``aligned`` off)."""
    base = route.replace("masked_matmul_batched", "masked_matmul")
    lead = (dims["E"],) if base != route else ()
    out = []
    for name, (a, b) in V._GEMM_OPS[base][:3]:
        rows, cols = dims[a], dims[b]
        if name == "m" and aligned:
            cols = -(-cols // 16) * 16
        out.append((V._contiguous((*lead, rows, cols)), 0))
    return out


def designed_stages(plan: KernelPlan) -> int:
    """The ring depth a plan's kernel is designed for; 0 for the SIMT
    kernels, which have no ring."""
    if plan.dtype != "bfloat16":
        return 0
    if plan.route == "flash_attention":
        return V.ATTN_RING_KEYS // plan.tiles["bk"]
    if plan.route == "flash_attention_bwd":
        return 2
    return V.GEMM_MAX_STAGES


def _labels(cfg: ModelConfig) -> Dict[Tuple, str]:
    """The leaf names behind each product shape: (K, N) of the 2-D leaves,
    (E, K, N) of the routed experts'."""
    out: Dict[Tuple, List[str]] = {}
    for label, _M, K, N in tuning.matmul_workloads(cfg, TUNE_TOKENS):
        out.setdefault((K, N), []).append(label)
    for label, E, _C, K, N in tuning.expert_workloads(cfg, TUNE_TOKENS):
        out.setdefault((E, K, N), []).append(label)
    return {k: "+".join(dict.fromkeys(v)) for k, v in out.items()}


def config_launches(cfg: ModelConfig, *, aligned_masks: bool = True) -> List[Launch]:
    """Every launch the kernel pass plans for ``cfg``, in bf16 and in the
    config's dtype."""
    labels = _labels(cfg)
    dtypes = list(dict.fromkeys(("bfloat16", cfg.dtype)))
    out: List[Launch] = []
    work = tuning.ebft_workloads(cfg, TUNE_TOKENS, CALIB_SEQ, pattern=NM)
    for kernel, dims, _dt, params in work:
        for dt in dtypes:
            if kernel == "flash_attention":
                BH, Sq, Sk, d = dims["BH"], dims["Sq"], dims["Sk"], dims["d"]
                shape = f"({BH}x{Sq}x{Sk}x{d}, {dt})"
                seqs = {"q": Sq, "k": Sk, "v": Sk, "o": Sq, "do": Sq}
                for route, names in (("flash_attention", ("q", "k", "v")),
                                     ("flash_attention_bwd", tuple(seqs))):
                    ops = {n: (V._contiguous((BH, seqs[n], d)), 0) for n in names}
                    out.append((f"{route}/ebft {shape}", route, partial(
                        V.plan_flash_attention, BH, Sq, Sk, d, dtype=dt,
                        causal=params["causal"], route=route, operands=ops)))
                continue
            M, K, N = dims["M"], dims["K"], dims["N"]
            key = (dims["E"], K, N) if "E" in dims else (K, N)
            where = f"{kernel}/{labels.get(key, '?')} ({M}x{K}x{N}, {dt})"
            if kernel == "nm_spmm":
                out.append((where, kernel, partial(V.plan_nm_spmm, M, K, N, n=params["n"],
                                                    m=params["m"], dtype=dt)))
            else:
                out.append((where, kernel, partial(
                    V.plan_masked_matmul, kernel, M, K, N, dims.get("E", 1), dtype=dt,
                    operands=mask_operands(kernel, dims, aligned_masks))))
    if cfg.family != "ssm":
        H, d = cfg.num_heads, cfg.resolved_head_dim
        for s in cfg.shapes():
            Sq, off = (1, s.seq_len - 1) if s.kind == "decode" else (s.seq_len, 0)
            BH = s.global_batch * H
            for dt in dtypes:
                out.append((f"flash_attention/{s.name} ({BH}x{Sq}x{s.seq_len}x{d}, {dt})",
                            "flash_attention", partial(V.plan_flash_attention, BH, Sq,
                                                       s.seq_len, d, dtype=dt, q_offset=off)))
    return out


def plan_findings(plan: KernelPlan, config: str, location: str) -> List[Finding]:
    """KER002–004 of one built plan."""
    findings: List[Finding] = []

    def add(code, severity, message):
        findings.append(Finding(code=code, severity=severity, pass_name="kernels",
                                config=config, location=location, message=message))

    if plan.smem > V.SMEM_MAX:
        add("KER002", "error", f"{plan.smem} bytes of dynamic shared memory exceed a block's "
                               f"{V.SMEM_MAX} (tiles {plan.tiles})")
    for problem in (p for mp in plan.maps for p in mp.problems()):
        add("KER003", "error", problem)
    if plan.grid[1] > V.MAX_GRID_YZ or plan.grid[2] > V.MAX_GRID_YZ:
        add("KER003", "error", f"grid {plan.grid} has a y or z above {V.MAX_GRID_YZ}")
    want = designed_stages(plan)
    if plan.stages < want:
        add("KER004", "info", f"the ring has {plan.stages} stages, fewer than the "
                              f"{want} its kernel is designed for (tiles {plan.tiles})")
    return findings


def planned(name: str, cfg: ModelConfig, *, aligned_masks: bool = True
            ) -> Tuple[List[Tuple[str, KernelPlan]], List[Finding]]:
    """(the built plans by location, the findings): KER001 for each launch
    whose builder refuses it (KER005 for an ``nm_spmm`` one), KER002–004 of
    the plans that build, and KER005 for each 2-D leaf whose K is not a
    multiple of M."""
    plans: List[Tuple[str, KernelPlan]] = []
    findings: List[Finding] = []
    n, m = NM
    for location, kernel, build in config_launches(cfg, aligned_masks=aligned_masks):
        try:
            plan = build()
        except ValueError as e:
            if kernel == "nm_spmm":
                findings.append(Finding(
                    code="KER005", severity="warn", pass_name="kernels", config=name,
                    location=location,
                    message=f"{n}:{m} compression unavailable for this leaf: {e}"))
            else:
                findings.append(Finding(code="KER001", severity="error", pass_name="kernels",
                                        config=name, location=location, message=str(e)))
            continue
        plans.append((location, plan))
        findings += plan_findings(plan, name, location)
    labels = _labels(cfg)
    seen = set()
    for kernel, dims, _dt, _p in tuning.ebft_workloads(cfg, TUNE_TOKENS, CALIB_SEQ):
        K, N = dims.get("K"), dims.get("N")
        if kernel == "masked_matmul" and K % m and (K, N) not in seen:
            seen.add((K, N))
            findings.append(Finding(
                code="KER005", severity="warn", pass_name="kernels", config=name,
                location=f"nm_spmm/{labels.get((K, N), '?')}",
                message=f"reduction dim K={K} not divisible by M={m}; "
                        f"{n}:{m} compression unavailable for this matmul"))
    return plans, findings


def check_config_kernels(name: str, cfg: ModelConfig, *,
                         aligned_masks: bool = True) -> List[Finding]:
    return planned(name, cfg, aligned_masks=aligned_masks)[1]
