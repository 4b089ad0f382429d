"""Render run artifacts: trace tree + metric summaries, text or JSON (port
of ``repro.obs.report``; it renders either package's artifacts).

Accepts both artifact formats (JSON summary / JSONL stream). For the
summary format the span forest is rendered as an indented tree; for the
raw event stream, span-end events are shown flat, indented by recorded
depth (they arrive post-order, so the tree is not reconstructed).
"""
from __future__ import annotations

from typing import Any, Dict, List


def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def _fmt_attrs(attrs: Dict[str, Any]) -> str:
    if not attrs:
        return ""
    body = ", ".join(f"{k}={_fmt_val(v)}" for k, v in attrs.items())
    return f"  [{body}]"


def _span_lines(node: Dict[str, Any], depth: int, out: List[str]) -> None:
    out.append(
        f"{'  ' * depth}{node.get('name', '?'):<{max(40 - 2 * depth, 8)}}"
        f"{node.get('duration_s', 0.0):>10.3f}s"
        + _fmt_attrs(node.get("attrs", {}))
    )
    for child in node.get("children", []):
        _span_lines(child, depth + 1, out)


def _metric_line(name: str, s: Dict[str, Any]) -> str:
    kind = s.get("kind", "?")
    if kind == "counter":
        body = f"value={_fmt_val(s.get('value'))}"
    elif kind == "gauge":
        body = (f"last={_fmt_val(s.get('last'))} min={_fmt_val(s.get('min'))} "
                f"max={_fmt_val(s.get('max'))}")
    elif kind == "histogram":
        body = (f"n={s.get('count')} mean={_fmt_val(s.get('mean'))} "
                f"p50={_fmt_val(s.get('p50'))} p99={_fmt_val(s.get('p99'))} "
                f"max={_fmt_val(s.get('max'))}")
    elif kind == "series":
        body = (f"n={s.get('n')} first={_fmt_val(s.get('first'))} "
                f"last={_fmt_val(s.get('last'))} min={_fmt_val(s.get('min'))}")
    else:
        body = " ".join(f"{k}={_fmt_val(v)}" for k, v in s.items())
    return f"  {name:<44} {kind:<9} {body}"


def render_text(payload: Dict[str, Any]) -> str:
    lines: List[str] = []
    manifest = payload.get("manifest", {})
    if manifest:
        lines.append(f"run: {manifest.get('name', '?')}")
        for key in ("config", "method", "sparsity", "pattern", "git_rev",
                    "jax_backend", "device_count", "device_name"):
            if key in manifest:
                lines.append(f"  {key:<13} {manifest[key]}")

    phases = payload.get("phases")
    if isinstance(phases, dict) and phases:
        lines.append("phases:")
        for name, secs in phases.items():
            lines.append(f"  {name:<20} {float(secs):>10.3f}s")

    blocks = payload.get("blocks")
    if isinstance(blocks, list) and blocks:
        lines.append("blocks:")
        lines.append(
            "  idx kind            epochs  E_before    E_after     stop"
        )
        for b in blocks:
            lines.append(
                f"  {b.get('index', '?'):>3} {str(b.get('kind', '?')):<15} "
                f"{b.get('epochs_run', '?'):>6}  "
                f"{_fmt_val(b.get('loss_before')):<11} "
                f"{_fmt_val(b.get('loss_after')):<11} "
                f"{b.get('early_stop', '')}"
            )

    trace = payload.get("trace")
    if isinstance(trace, list) and trace:
        lines.append("trace:")
        for root in trace:
            sub: List[str] = []
            _span_lines(root, 1, sub)
            lines.extend(sub)

    events = payload.get("events")
    if isinstance(events, list) and events:
        spans = [e for e in events if e.get("type") == "span"]
        if spans:
            lines.append("spans (event stream, close order):")
            for ev in spans:
                depth = int(ev.get("depth", 0))
                lines.append(
                    f"  {'  ' * depth}{ev.get('name', '?'):<{max(38 - 2 * depth, 8)}}"
                    f"{ev.get('duration_s', 0.0):>10.3f}s"
                    + _fmt_attrs(ev.get("attrs", {}))
                )
        counts: Dict[str, int] = {}
        for ev in events:
            counts[ev.get("type", "?")] = counts.get(ev.get("type", "?"), 0) + 1
        lines.append("events: " + ", ".join(
            f"{n} {t}" for t, n in sorted(counts.items())))

    metrics = payload.get("metrics")
    if isinstance(metrics, dict) and metrics:
        lines.append("metrics:")
        for name in sorted(metrics):
            lines.append(_metric_line(name, metrics[name]))

    return "\n".join(lines) if lines else "(empty artifact)"
