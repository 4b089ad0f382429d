"""Output sinks: JSONL event stream, JSON summaries, console lines (port of
``repro.obs.sinks``; the same two formats, readable by either package).

  * **JSONL** — one event object per line, appended as spans close and
    metrics update, flushed per event so it survives a crash mid-run. The
    first line is always the run manifest (``{"type": "manifest", ...}``).
  * **JSON summary** — one document written at ``Run.finish()``:
    manifest + metric summaries + the span tree + the launcher's sections
    (the ``BENCH_*.json`` artifact the report CLI renders).

``ConsoleSink`` keeps the launchers' human-readable output: it is a line
printer, but routing through it means the same call sites feed humans
and machines.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def _jsonable(v):
    """Best-effort JSON coercion for numpy scalars and 0-d CPU tensors, in
    attrs too. A CUDA tensor is refused: reading it would synchronise."""
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            raise TypeError("obs sinks take host values, not CUDA tensors")
        if v.dim() == 0:
            return v.item() if v.dtype == torch.bool else float(v)
        return repr(v)
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except Exception:
            return repr(v)


class JsonlSink:
    """Append-mode JSONL event writer (flushes per event: crash-safe)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def emit(self, event: Dict[str, Any]) -> None:
        self._f.write(json.dumps(
            {k: _jsonable(v) for k, v in event.items()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class ConsoleSink:
    """Human-readable line printer (the launchers' stdout reporting)."""

    def emit_line(self, line: str) -> None:
        print(line, flush=True)


def write_summary(path: str, payload: Dict[str, Any]) -> str:
    """Write a JSON-summary artifact; returns the path."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=_jsonable)
        f.write("\n")
    return path


def read_jsonl(path: str):
    """Parse a JSONL event stream back into a list of event dicts."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def load_artifact(path: str) -> Optional[Dict[str, Any]]:
    """Load either artifact format: a JSON-summary document, or a JSONL
    event stream (reassembled into {"manifest", "events"})."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict) and doc.get("type") != "manifest":
            return doc  # a summary document spans the whole file
    except json.JSONDecodeError:
        pass  # multiple lines: JSONL
    events = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    manifest: Dict[str, Any] = {}
    for ev in events:
        if ev.get("type") == "manifest":
            manifest = ev.get("manifest", {})
            break
    return {"manifest": manifest, "events": events}
