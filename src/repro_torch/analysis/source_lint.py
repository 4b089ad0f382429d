"""Source-hygiene pass: keep ad-hoc I/O, clocks, and host syncs out of
hot paths (the port of ``repro.analysis.source_lint``).

Library code under ``src/repro_torch`` must not reach for ``print()`` or
``time.time()`` directly, and hot loops must not force device→host
round-trips:

  * ``print()`` in a hot-path package (OBS001) bypasses the sink model —
    output is invisible to artifacts and un-silenceable in benchmarks.
    Launch drivers and CLIs are exempt: console text is their job (they
    route it through ``Run.say`` when a run is active).
  * ``time.time()`` anywhere in ``src/repro_torch`` (OBS002) is the wrong
    clock for measurement — it is not monotonic (NTP steps produce
    negative durations). Spans use ``time.perf_counter``; wall-clock
    timestamps belong in the run manifest only.
  * a host read inside a ``for``/``while`` loop in a hot-path package
    (OBS003): the reference's ``float(...)`` and ``np.asarray(...)``, and
    torch's own ``.item()``, ``.tolist()`` and ``.cpu()``. On a CUDA
    tensor each blocks the host on the card's stream once an iteration,
    so the host can no longer queue launches ahead of the card. Reduce on
    the device and read one value after the loop — or, where the read is
    the point (a host-side convergence check, the sampled token a server
    hands back, user-requested logging), annotate the line or the line
    above it with ``obs: sync-ok`` and a reason.

The reference's API001 (deprecated launcher flags in in-repo callers) has
nothing to guard here: the port's ``launch/api.py`` keeps no deprecated
spelling.

The pass is config-independent: it scans the source tree once per
analysis run, skipping ``repro_torch.obs`` (it *implements* the clocks
and sinks) and ``repro_torch.analysis`` (self-scan).
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding

# packages where print() / in-loop host syncs are findings; launch/ and
# configs/ are CLIs and declarative tables — console output is legitimate
# there.
HOT_PATH_DIRS = (
    "core", "training", "serving", "kernels", "optim", "sparsity",
    "models", "distributed", "checkpoint", "data",
)

# never scanned: obs implements the sinks/clocks, analysis is this pass.
EXCLUDE_DIRS = ("obs", "analysis")

_PRINT = re.compile(r"(?<![\w.])print\s*\(")
_TIME_TIME = re.compile(r"(?<![\w.])time\.time\s*\(")
_HOST_SYNC = re.compile(r"(?<![\w.])(?:float|np\.asarray)\s*\(|\.(?:item|tolist|cpu)\s*\(")
_LOOP_HEADER = re.compile(r"^\s*(?:for|while)\b.*:")
_SYNC_OK = "obs: sync-ok"


def _code_part(line: str) -> str:
    """Strip a trailing comment (best-effort: ignores '#' inside strings
    only when the line starts as a comment — good enough for a lint)."""
    stripped = line.lstrip()
    if stripped.startswith("#"):
        return ""
    return line


def _scan_file(path: str, rel: str, in_hot_path: bool) -> List[Finding]:
    findings: List[Finding] = []
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return findings
    loop_indents: List[int] = []  # indents of the enclosing loop headers
    prev_sync_ok = False
    for lineno, raw in enumerate(lines, start=1):
        line = _code_part(raw)
        if not line.strip():
            prev_sync_ok = prev_sync_ok or _SYNC_OK in raw
            continue
        indent = len(line) - len(line.lstrip())
        while loop_indents and indent <= loop_indents[-1]:
            loop_indents.pop()
        where = f"{rel}:{lineno}"
        if in_hot_path and _PRINT.search(line):
            findings.append(Finding(
                code="OBS001", severity="warn", pass_name="source_lint",
                location=where,
                message="print() in hot-path package; use the obs console "
                        "sink (repro_torch.obs run.say) or a metric instead",
            ))
        if _TIME_TIME.search(line):
            findings.append(Finding(
                code="OBS002", severity="warn", pass_name="source_lint",
                location=where,
                message="time.time() is non-monotonic; use "
                        "time.perf_counter() (or an obs span) for timing",
            ))
        if (in_hot_path and loop_indents and _HOST_SYNC.search(line)
                and _SYNC_OK not in raw and not prev_sync_ok):
            findings.append(Finding(
                code="OBS003", severity="warn", pass_name="source_lint",
                location=where,
                message="float()/np.asarray()/.item()/.tolist()/.cpu() inside "
                        "a loop forces a device→host sync per iteration; "
                        "reduce on device and transfer once after the loop, "
                        "or annotate 'obs: sync-ok <reason>'",
            ))
        if _LOOP_HEADER.match(line):
            loop_indents.append(indent)
        prev_sync_ok = _SYNC_OK in raw
    return findings


def check_sources(src_root: Optional[str] = None) -> List[Finding]:
    """Scan ``src/repro_torch`` (or ``src_root``) for OBS0xx hygiene
    findings; locations are ``repro_torch/<path>:<line>``."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(src_root):
        rel_dir = os.path.relpath(dirpath, src_root)
        top = rel_dir.split(os.sep)[0]
        if top in EXCLUDE_DIRS:
            dirnames[:] = []
            continue
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        in_hot_path = top in HOT_PATH_DIRS
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            rel = os.path.join("repro_torch", rel_dir, fname) if rel_dir != "." \
                else os.path.join("repro_torch", fname)
            findings.extend(
                _scan_file(os.path.join(dirpath, fname), rel, in_hot_path)
            )
    return findings
