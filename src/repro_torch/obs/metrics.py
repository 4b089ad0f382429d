"""Metrics registry: counters, gauges, histograms, time-series (port of
``repro.obs.metrics``; the same instruments and the same ``summary()``
dicts).

Four instrument kinds:

  * ``counter``   — monotone accumulator (steps run, kernel calls and
    FLOPs);
  * ``gauge``     — last value plus running min/max, so peaks survive
    the summary (``ebft/live_block_bytes``'s max is the paper's
    peak-live-memory claim);
  * ``histogram`` — count/sum/min/max plus a bounded sample reservoir
    for percentiles (per-step and per-launch times);
  * ``series``    — (step, value) pairs (loss curves).

Like the tracer, the module-level facade dispatches to the current
registry — a null singleton by default whose instruments are shared
no-op objects, so disabled instrumentation allocates nothing.

Every value is a host number. ``float()`` of a CUDA tensor waits for the
device, so an instrument refuses one (``TypeError``) rather than add a
hidden synchronise to the loop that feeds it.

``Metrics.summary()`` is the JSON-ready digest embedded in run
artifacts; every update can also be streamed to JSONL emitters.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

_RESERVOIR = 4096  # histogram sample cap; scalar stats stay exact beyond it


def _host(v) -> float:
    """``float(v)``, refusing a CUDA tensor (reading it would synchronise)."""
    if getattr(v, "is_cuda", False):
        raise TypeError("a metric takes host numbers; read the CUDA tensor where the "
                        "loop already waits for it")
    return float(v)


class Counter:
    __slots__ = ("name", "value", "_emit")
    kind = "counter"

    def __init__(self, name: str, emit=None):
        self.name = name
        self.value = 0.0
        self._emit = emit

    def inc(self, n: float = 1.0) -> None:
        self.value += _host(n)
        if self._emit:
            self._emit({"type": "counter", "name": self.name, "inc": n,
                        "value": self.value})

    def summary(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    __slots__ = ("name", "last", "min", "max", "n", "_emit")
    kind = "gauge"

    def __init__(self, name: str, emit=None):
        self.name = name
        self.last: Optional[float] = None
        self.min = math.inf
        self.max = -math.inf
        self.n = 0
        self._emit = emit

    def set(self, v: float) -> None:
        v = _host(v)
        self.last = v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.n += 1
        if self._emit:
            self._emit({"type": "gauge", "name": self.name, "value": v})

    def summary(self) -> Dict[str, Any]:
        return {"kind": self.kind, "last": self.last, "min": self.min,
                "max": self.max, "n": self.n}


class Histogram:
    __slots__ = ("name", "count", "total", "min", "max", "samples", "_emit")
    kind = "histogram"

    def __init__(self, name: str, emit=None):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: List[float] = []
        self._emit = emit

    def observe(self, v: float) -> None:
        v = _host(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < _RESERVOIR:
            self.samples.append(v)
        if self._emit:
            self._emit({"type": "histogram", "name": self.name, "value": v})

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        s = sorted(self.samples)
        i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[i]

    def summary(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "count": self.count, "sum": self.total,
            "mean": self.total / self.count if self.count else None,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": self.percentile(50), "p99": self.percentile(99),
        }


class Series:
    __slots__ = ("name", "points", "_emit")
    kind = "series"

    def __init__(self, name: str, emit=None):
        self.name = name
        self.points: List[Tuple[float, float]] = []
        self._emit = emit

    def append(self, value: float, step: Optional[float] = None) -> None:
        step = float(len(self.points) if step is None else step)
        value = _host(value)
        self.points.append((step, value))
        if self._emit:
            self._emit({"type": "series", "name": self.name, "step": step,
                        "value": value})

    def summary(self) -> Dict[str, Any]:
        vals = [v for _, v in self.points]
        return {
            "kind": self.kind, "n": len(vals),
            "first": vals[0] if vals else None,
            "last": vals[-1] if vals else None,
            "min": min(vals) if vals else None,
            "max": max(vals) if vals else None,
            "points": [[s, v] for s, v in self.points],
        }


class Metrics:
    """Live registry: get-or-create instruments by name (kind-checked)."""

    enabled = True

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._emit_fns: List[Callable[[Dict[str, Any]], None]] = []

    def add_emitter(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        self._emit_fns.append(fn)

    def _emit(self, event: Dict[str, Any]) -> None:
        for fn in self._emit_fns:
            fn(event)

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, self._emit if self._emit_fns else None)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def series(self, name: str) -> Series:
        return self._get(name, Series)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: inst.summary()
            for name, inst in sorted(self._instruments.items())
        }


class _NullInstrument:
    """Shared no-op instrument (answers every kind's API)."""

    __slots__ = ()
    name = ""
    kind = "null"

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def append(self, value: float, step: Optional[float] = None) -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    gauge = histogram = series = counter

    def add_emitter(self, fn) -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {}


NULL_METRICS = NullMetrics()
_REGISTRY: Any = NULL_METRICS


def get_registry():
    return _REGISTRY


def set_registry(registry: Optional[Metrics]) -> None:
    """Install ``registry`` as the process registry (None restores null)."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else NULL_METRICS


def counter(name: str):
    return _REGISTRY.counter(name)


def gauge(name: str):
    return _REGISTRY.gauge(name)


def histogram(name: str):
    return _REGISTRY.histogram(name)


def series(name: str):
    return _REGISTRY.series(name)


def summary() -> Dict[str, Any]:
    return _REGISTRY.summary()


def enabled() -> bool:
    return _REGISTRY.enabled
