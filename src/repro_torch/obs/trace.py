"""Span tracer: nested wall-time spans with optional device fencing (port
of ``repro.obs.trace``).

A :class:`Span` measures host wall time between ``__enter__`` and
``__exit__`` on the monotonic clock. A CUDA launch returns as soon as the
work is queued, so a span around ``step(...)`` alone times the launch;
``sp.fence(value)`` waits, inside the span, for the current stream of
each device that holds a CUDA tensor of ``value``, so the device work is
attributed to the span that launched it. On CPU tensors (which PyTorch
computes synchronously) it does nothing.

The module-level :func:`span` dispatches to the current tracer: a
:class:`NullTracer` by default, whose ``span()`` returns a stateless no-op
singleton, so instrumented hot paths cost one attribute lookup when
observability is off. ``start_run`` (``repro_torch.obs.run``) installs a
live :class:`Tracer`.

Spans must be strictly nested (they form a tree); the tracer keeps the
open-span stack and the list of completed roots. ``Tracer.tree()``
returns the JSON-ready forest the report CLI renders; its keys and the
span-end event's are the reference's.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import tree as T


def fence(value):
    """Wait for the work queued so far on the current stream of every
    device that holds a CUDA tensor of ``value`` (a nest of dicts, lists
    and tuples): an event recorded there and synchronised. Returns
    ``value``. The counterpart of ``jax.block_until_ready(value)``, which
    waits for that value only: work on another stream (the EBFT walk's
    teacher, prefetched on a side stream) is not waited for."""
    for dev in {t.device for t in T.tensors(value) if t.is_cuda}:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    return value


class Span:
    """One timed region. Context manager; re-entry is not supported."""

    __slots__ = ("name", "attrs", "start", "duration", "children", "_tracer")

    def __init__(self, name: str, attrs: Dict[str, Any], tracer: "Tracer"):
        self.name = name
        self.attrs = attrs
        self.start: float = 0.0
        self.duration: float = 0.0
        self.children: List["Span"] = []
        self._tracer = tracer

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered while the span is open."""
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Wait for ``value``'s device work; returns ``value``. Puts the
        queued work inside this span's wall time."""
        return fence(value)

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.start = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration = self._tracer.clock() - self.start
        self._tracer._pop(self)
        return False

    def asdict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "start": self.start,
            "duration_s": self.duration,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.asdict() for c in self.children]
        return d


class _NullSpan:
    """Stateless no-op span: one shared instance, safe to re-enter."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    start = 0.0
    duration = 0.0
    children: List = []

    def set(self, **attrs):
        return self

    def fence(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects a forest of completed spans; emits span-end events."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self._emit: List[Callable[[Dict[str, Any]], None]] = []

    def span(self, name: str, **attrs) -> Span:
        return Span(name, attrs, self)

    def add_emitter(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """``fn(event_dict)`` is called at every span end (JSONL sinks)."""
        self._emit.append(fn)

    # -- stack maintenance (called by Span) -----------------------------
    def _push(self, sp: Span) -> None:
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self.roots.append(sp)
        self._stack.append(sp)

    def _pop(self, sp: Span) -> None:
        # tolerate exceptions unwinding several spans at once: pop to sp
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
        if self._emit:
            ev = {
                "type": "span",
                "name": sp.name,
                "start": sp.start,
                "duration_s": sp.duration,
                "depth": len(self._stack),
            }
            if sp.attrs:
                ev["attrs"] = dict(sp.attrs)
            for fn in self._emit:
                fn(ev)

    def tree(self) -> List[Dict[str, Any]]:
        return [r.asdict() for r in self.roots]


class NullTracer:
    """Default tracer: observability off, everything is a no-op."""

    enabled = False
    roots: List[Span] = []

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def add_emitter(self, fn) -> None:
        pass

    def tree(self) -> List[Dict[str, Any]]:
        return []


NULL_TRACER = NullTracer()
_TRACER: Any = NULL_TRACER


def get_tracer():
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install ``tracer`` as the process tracer (None restores the null)."""
    global _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER


def span(name: str, **attrs):
    """Open a span on the current tracer (no-op when disabled)."""
    return _TRACER.span(name, **attrs)


def enabled() -> bool:
    return _TRACER.enabled
