"""repro_torch.analysis — static invariant checks for the port (the port of
``repro.analysis``).

Six passes, one report (``python -m repro_torch.analysis``):

  * ``kernels``  — every launch a config's EBFT walk and its serving make,
    at the config's full widths, planned in bf16 and in the config's dtype
    by the same :mod:`repro_torch.kernels.validation` builders the wrappers
    launch through: refused launches, shared memory, tensor maps, grid
    limits, ring depth, N:M availability (KER0xx);
  * ``masks``    — taint-based proof, over the aten graph of the traced
    EBFT tune step, that every prunable weight is masked before any
    contraction, plus concrete N:M mask-tree validation (MSK0xx);
  * ``graph``    — lint of the traced EBFT tune step and serving decode
    step: silent widenings, host reads, cast round-trips (LNT0xx);
  * ``sharding`` — config arithmetic (CFG0xx), then the sharding rules
    on the production 16 × 16 mesh, leaf by leaf, and the EBFT walk's
    ``MeshPlan`` layouts (SHD0xx); the reference's HLO checks have no
    counterpart (the port compiles no HLO);
  * ``source_lint`` — config-independent source hygiene: ``print()`` in
    hot-path packages, non-monotonic ``time.time()`` anywhere in
    ``src/repro_torch``, and host reads inside hot loops must go through
    repro_torch.obs or carry ``obs: sync-ok`` (OBS0xx);
  * ``tuning_cache`` — config-independent validation of the kernel
    autotuner's persistent plan cache: every entry must rebuild through
    the live plan builders, fit a block's shared memory, and match the
    current kernel ``code_rev`` (TUN0xx).

Findings carry stable codes and severities (error/warn/info); the CLI
exit code is governed by ``--fail-on`` and individual codes can be
silenced with ``--ignore CODE``. The mask and graph passes trace on the
CPU; nothing here needs a card.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import SEVERITIES, Finding, Report
from repro_torch.analysis.passes import PASSES
from repro_torch.configs import CONFIG_IDS, get_config
from repro_torch.configs.base import ModelConfig

# per-config passes from PASSES, plus the config-independent scans
PASS_NAMES = tuple(PASSES) + ("source_lint", "tuning_cache")

__all__ = [
    "Finding", "Report", "SEVERITIES", "PASS_NAMES",
    "resolve_configs", "run",
]


def resolve_configs(
    names: Optional[Sequence[str]] = None,
) -> List[Tuple[str, ModelConfig, ModelConfig]]:
    """(name, real CONFIG, SMOKE variant) triples for the requested config
    names (default: every registered config)."""
    if not names:
        names = list(CONFIG_IDS)
    out = []
    for name in names:
        try:
            out.append((name, get_config(name), get_config(name, smoke=True)))
        except KeyError:
            raise ValueError(
                f"unknown config {name!r}; available: " + ", ".join(CONFIG_IDS)
            ) from None
    return out


def _guarded(report: Report, pass_name: str, fn, config: str = "") -> None:
    try:
        report.add(fn())
    except Exception as e:  # a crashed pass is itself a finding
        report.add([Finding(
            code="ANA000", severity="error", pass_name=pass_name,
            config=config, location="internal",
            message=f"pass crashed: {type(e).__name__}: {e}",
        )])


def run(
    config_names: Optional[Sequence[str]] = None,
    passes: Optional[Sequence[str]] = None,
    extra_configs: Optional[Iterable[Tuple[str, ModelConfig]]] = None,
    tuning_cache_path: Optional[str] = None,
    progress=None,
) -> Report:
    """Run the requested passes over the requested configs.

    ``extra_configs`` injects (name, cfg) pairs not in the registry (the
    cfg doubles as its own smoke variant — keep injected configs small).
    ``tuning_cache_path`` points the ``tuning_cache`` pass at a specific
    plan-cache file (default: the autotuner's configured path).
    ``progress`` is an optional ``callable(str)`` for per-config status.
    """
    selected = list(passes) if passes else list(PASS_NAMES)
    for p in selected:
        if p not in PASS_NAMES:
            raise ValueError(f"unknown pass {p!r}; available: {PASS_NAMES}")

    triples = resolve_configs(config_names)
    if extra_configs:
        triples += [(name, cfg, cfg) for name, cfg in extra_configs]

    report = Report(passes_run=selected,
                    configs_checked=[t[0] for t in triples])
    per_config = [p for p in selected if p in PASSES]
    for name, cfg, smoke in triples:
        for pname in per_config:
            if progress:
                progress(f"{pname:<9} {name}")
            _guarded(report, pname, lambda: PASSES[pname](name, cfg, smoke), name)

    if "source_lint" in selected:
        from repro_torch.analysis.source_lint import check_sources

        if progress:
            progress("source_lint src/repro_torch")
        _guarded(report, "source_lint", check_sources)

    if "tuning_cache" in selected:
        from repro_torch.analysis.tuning_cache import check_cache

        if progress:
            progress("tuning_cache")
        _guarded(report, "tuning_cache", lambda: check_cache(tuning_cache_path))
    return report
