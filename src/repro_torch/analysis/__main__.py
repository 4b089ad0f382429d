"""CLI: ``python -m repro_torch.analysis [options]``.

Runs the static-analysis passes over every registered config (or a
subset) and prints severity-ranked findings — human text by default,
``--json`` for machines. Exit code is 1 when any finding reaches the
``--fail-on`` severity (default: error), so shipped configs gate CI.

Examples::

    python -m repro_torch.analysis                       # everything
    python -m repro_torch.analysis --configs llama_7b --passes kernels masks
    python -m repro_torch.analysis --json --fail-on warn --ignore KER005
    python -m repro_torch.analysis --extra-config-module my_bad_configs
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time

import torch

from repro_torch.analysis import PASS_NAMES, run
from repro_torch.configs import CONFIG_IDS


def _load_extra(module_name: str):
    """Import ``module_name`` and return its ``ANALYSIS_CONFIGS`` list of
    (name, ModelConfig) pairs — the hook tests use to seed violations."""
    mod = importlib.import_module(module_name)
    pairs = getattr(mod, "ANALYSIS_CONFIGS", None)
    if pairs is None:
        raise SystemExit(
            f"--extra-config-module: {module_name} has no ANALYSIS_CONFIGS"
        )
    return list(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checks for the port's kernel plans, masks, "
                    "traced graphs, configs, sources and tuning cache.",
    )
    ap.add_argument("--configs", nargs="*", default=None,
                    metavar="NAME",
                    help=f"config subset (default: all — {', '.join(CONFIG_IDS)})")
    ap.add_argument("--passes", nargs="*", default=None, choices=PASS_NAMES,
                    help="pass subset (default: all six)")
    ap.add_argument("--fail-on", default="error",
                    choices=("error", "warn", "info", "never"),
                    help="minimum severity that makes the exit code "
                         "non-zero (default: error)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of text")
    ap.add_argument("--ignore", action="append", default=[], metavar="CODE",
                    help="silence a finding code (repeatable), e.g. "
                         "--ignore KER005")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="plan-cache file for the tuning_cache pass "
                         "(default: the autotuner's configured path)")
    ap.add_argument("--extra-config-module", default=None, metavar="MODULE",
                    help="import MODULE and also check its ANALYSIS_CONFIGS "
                         "[(name, ModelConfig), ...]")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-config progress on stderr")
    args = ap.parse_args(argv)

    extra = _load_extra(args.extra_config_module) if args.extra_config_module else None
    progress = None
    if not args.quiet and not args.json:
        progress = lambda s: print(f"  ... {s}", file=sys.stderr)  # noqa: E731

    t0 = time.monotonic()
    # the traces run the SMOKE models' tiny operations: a thread pool only
    # adds its waits (and, on a busy machine, its spinning)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        report = run(
            config_names=args.configs,
            passes=args.passes,
            extra_configs=extra,
            tuning_cache_path=args.tuning_cache,
            progress=progress,
        ).without(args.ignore)
    except ValueError as e:
        ap.error(str(e))
    finally:
        torch.set_num_threads(threads)

    if args.json:
        print(report.to_json())
    else:
        print(report.to_text())
        print(f"-- analysis took {time.monotonic() - t0:.1f}s")
    return report.exit_code(args.fail_on)


if __name__ == "__main__":
    sys.exit(main())
