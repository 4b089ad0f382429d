"""Run lifecycle: manifest + live tracer/registry + sinks, per process
(port of ``repro.obs.run``, schema ``repro.obs/v1``).

``start_run`` swaps the null tracer/metrics singletons for live ones and
records the run manifest (what was run: config, sparsity, method, git
rev, device). ``Run.finish`` assembles the JSON-summary payload

    {"manifest": ..., "metrics": ..., "trace": ..., **extra}

optionally writes it (``summary_path``: this is how ``BENCH_ebft.json``
is produced), closes sinks, and restores the null singletons, so runs
never leak state into later code (tests rely on this).

The manifest keeps the schema's field names, which the reference's
validator requires: ``jax_backend`` holds the torch device type the run
uses (``"cuda"`` or ``"cpu"``) and ``device_count`` the number of CUDA
devices (1 on the CPU); ``device_name``, ``torch_version`` and
``cuda_version`` stand beside them.

Kernel launches recorded with CUDA events (``profile.record_kernel``)
are resolved in ``Run.payload``, after one device synchronise, and the
pending pairs are dropped when the run finishes.

``validate_payload`` is the manifest schema check artifacts are gated on.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs import metrics as M
from repro_torch.obs import profile as P
from repro_torch.obs import trace as T
from repro_torch.obs.sinks import ConsoleSink, JsonlSink, write_summary

SCHEMA = "repro.obs/v1"


def git_rev() -> Optional[str]:
    """Short git revision of the working tree, or None outside a repo."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _backend(device) -> Dict[str, Any]:
    """The schema's backend fields for the torch device the run uses."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return {
        "jax_backend": dev.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


@dataclasses.dataclass
class Run:
    """One observed run: manifest + live tracer/metrics + sinks."""

    manifest: Dict[str, Any]
    tracer: T.Tracer
    metrics: M.Metrics
    jsonl: Optional[JsonlSink] = None
    console: Optional[ConsoleSink] = None
    _finished: bool = False

    def say(self, line: str) -> None:
        """Human-readable console output (a sink, not a side channel)."""
        if self.console is not None:
            self.console.emit_line(line)

    def payload(self, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if not self._finished:
            P.flush_kernels()  # book the launches' event pairs first
        out: Dict[str, Any] = {
            "manifest": self.manifest,
            "metrics": self.metrics.summary(),
            "trace": self.tracer.tree(),
        }
        if extra:
            out.update(extra)
        return out

    def finish(
        self,
        extra: Optional[Dict[str, Any]] = None,
        summary_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Assemble the summary payload, write it, release global state."""
        payload = self.payload(extra)
        if summary_path:
            write_summary(summary_path, payload)
        if not self._finished:
            self._finished = True
            P.drop_pending_kernels()
            if self.jsonl is not None:
                self.jsonl.close()
            global _CURRENT
            if _CURRENT is self:
                _CURRENT = None
                T.set_tracer(None)
                M.set_registry(None)
        return payload


_CURRENT: Optional[Run] = None


def current_run() -> Optional[Run]:
    return _CURRENT


def start_run(
    name: str,
    *,
    device,
    config: Optional[str] = None,
    method: Optional[str] = None,
    sparsity: Optional[float] = None,
    pattern: Optional[str] = None,
    jsonl_path: Optional[str] = None,
    console: bool = True,
    extra_manifest: Optional[Dict[str, Any]] = None,
) -> Run:
    """Begin an observed run; installs live tracer/metrics process-wide.
    ``device`` is the torch device the run computes on (its manifest
    fields); it has no default, so no run on the card is labelled CPU.

    A second ``start_run`` while one is active finishes the old run first
    (launchers and benchmarks are sequential; nesting is a bug).
    """
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.finish()
    P.drop_pending_kernels()

    manifest: Dict[str, Any] = {
        "schema": SCHEMA,
        "name": name,
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "git_rev": git_rev(),
        **_backend(device),
    }
    if config is not None:
        manifest["config"] = config
    if method is not None:
        manifest["method"] = method
    if sparsity is not None:
        manifest["sparsity"] = sparsity
    if pattern:
        manifest["pattern"] = pattern
    if extra_manifest:
        manifest.update(extra_manifest)

    tracer = T.Tracer()
    registry = M.Metrics()
    jsonl = None
    if jsonl_path:
        jsonl = JsonlSink(jsonl_path)
        jsonl.emit({"type": "manifest", "manifest": manifest})
        tracer.add_emitter(jsonl.emit)
        registry.add_emitter(jsonl.emit)

    run = Run(
        manifest=manifest,
        tracer=tracer,
        metrics=registry,
        jsonl=jsonl,
        console=ConsoleSink() if console else None,
    )
    T.set_tracer(tracer)
    M.set_registry(registry)
    _CURRENT = run
    return run


# ---------------------------------------------------------------------------
# artifact schema validation (the gate for BENCH_*.json)
# ---------------------------------------------------------------------------
_MANIFEST_FIELDS = {
    "schema": str,
    "name": str,
    "created_unix": (int, float),
    "argv": list,
    "jax_backend": str,
    "device_count": int,
}


def validate_payload(
    payload: Any,
    require: Optional[List[str]] = None,
    max_dispatches_per_block: Optional[int] = None,
    require_cache_hits: bool = False,
) -> List[str]:
    """Returns a list of problems ([] = valid summary artifact).

    ``require`` names additional top-level keys the artifact must carry
    (e.g. ``["blocks", "phases"]`` for ``BENCH_ebft.json``).

    ``max_dispatches_per_block`` gates a dispatch budget: the
    artifact's ``dispatch.per_block_max`` must not exceed it.

    ``require_cache_hits`` gates a warm launch-config cache run: the
    artifact's ``kernel_tuning`` section must show every plan resolution
    served from the cache — at least one hit, zero misses, zero searches,
    zero search seconds: an ``ebft_run`` on a warm ``--kernel-cache`` in
    ``--kernel-tune cache`` passes it.
    """
    problems: List[str] = []
    if not isinstance(payload, dict):
        return [f"artifact is {type(payload).__name__}, expected object"]

    manifest = payload.get("manifest")
    if not isinstance(manifest, dict):
        problems.append("missing 'manifest' object")
    else:
        for field, typ in _MANIFEST_FIELDS.items():
            if field not in manifest:
                problems.append(f"manifest missing {field!r}")
            elif not isinstance(manifest[field], typ):
                problems.append(
                    f"manifest.{field} has type "
                    f"{type(manifest[field]).__name__}"
                )
        if isinstance(manifest.get("schema"), str) \
                and manifest["schema"] != SCHEMA:
            problems.append(
                f"manifest.schema is {manifest['schema']!r}, "
                f"expected {SCHEMA!r}"
            )

    if not isinstance(payload.get("metrics"), dict):
        problems.append("missing 'metrics' object")
    if not isinstance(payload.get("trace"), list):
        problems.append("missing 'trace' span forest")
    for key in require or []:
        if key not in payload:
            problems.append(f"missing required key {key!r}")

    if max_dispatches_per_block is not None:
        dispatch = payload.get("dispatch")
        if not isinstance(dispatch, dict):
            problems.append(
                "missing 'dispatch' object (needed for "
                "--max-dispatches-per-block)"
            )
        else:
            per_block = dispatch.get("per_block_max")
            if not isinstance(per_block, int):
                problems.append(
                    "dispatch.per_block_max missing or non-integer"
                )
            elif per_block > max_dispatches_per_block:
                problems.append(
                    f"dispatch.per_block_max = {per_block} exceeds "
                    f"budget {max_dispatches_per_block}"
                )

    if require_cache_hits:
        tuning = payload.get("kernel_tuning")
        if not isinstance(tuning, dict):
            problems.append(
                "missing 'kernel_tuning' object (needed for "
                "--require-cache-hits)"
            )
        else:
            hits = tuning.get("hits")
            if not isinstance(hits, (int, float)) or hits < 1:
                problems.append(
                    f"kernel_tuning.hits = {hits!r}, expected >= 1 "
                    "(a warm run must resolve at least one plan)"
                )
            for field in ("misses", "searches", "search_s"):
                val = tuning.get(field)
                if not isinstance(val, (int, float)) or val != 0:
                    problems.append(
                        f"kernel_tuning.{field} = {val!r}, expected 0 "
                        "on a warm cache run"
                    )
    return problems
