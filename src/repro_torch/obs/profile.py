"""Profiling hooks: first-call vs steady-state timing, kernel FLOPs/bytes
accounting against the H100 roofline, and tree memory accounting (port
of ``repro.obs.profile``).

  * :class:`ProfiledFn` wraps a step. The first call for each argument
    signature (shapes, dtypes, devices) is fenced and booked as
    ``<name>/compile_s`` with ``<name>/compiles``: nothing is compiled
    ahead of time in the port, but that call holds the lazy load of the
    kernel libraries and cuBLAS's set-up. Every later call is fenced into
    ``<name>/exec_s`` and ``<name>/calls``. With observability off the
    wrapper is one branch around the raw function.

  * :func:`record_kernel` books one kernel launch and its analytic
    FLOPs/bytes against the roofline (``launch/rooflines.py``), with the
    ideal time beside the measured one. **The one deliberate difference
    from the reference**, which fences every launch with
    ``block_until_ready``: on the card the launch is bracketed by a
    ``torch.cuda.Event(enable_timing=True)`` pair recorded on the current
    stream, and nothing synchronises there. The pairs are resolved by
    :func:`flush_kernels` after one device synchronise, which
    ``Run.payload``/``Run.finish`` call; only then are
    ``kernels/<name>/exec_s``, ``calls``, ``flops``, ``bytes`` and
    ``roofline_ideal_s`` booked (and streamed to the JSONL sink). A fence
    per launch would serialise the host and the card on the thousand
    launches of an EBFT walk and change the times it reports. On the CPU
    the plain versions are synchronous, so the host clock serves and the
    launch is booked at once. A launch that runs a plan the tuner resolved
    (``kernels.tuning``: ``plan`` "cache" or "search", and the tiles) opens
    a kernel span carrying that plan, as the reference's does, so the
    artifact shows which plan each launch ran; the span is not fenced
    either, so its duration is the host's time to queue the launch.

  * :func:`live_bytes` / :func:`param_count` / :func:`ebft_live_block_bytes`
    account tree memory; the EBFT walk uses them to record the paper's
    streaming claim (peak live block = weights + masks + two f32 Adam
    moments) as a gauge.

  * :class:`FirstCallTimer` + :class:`CompileClock` attribute the host
    time of the first call per signature to the region that made it,
    without fencing; the EBFT walk drains the clock per phase so the
    ``ebft/walk/*_s`` histograms report steady state and the first calls
    land in ``ebft/walk/*_compile_s``. A signature is the nest's tensor
    shapes, dtypes and devices and the types of its other leaves: those
    are what make torch do first-time work (the reference keys static
    values by value, as ``jit`` recompiles on them; nothing recompiles
    here).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.launch.rooflines import HBM_BW, PEAK_FLOPS
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as OT


def param_count(tree: Any) -> int:
    """Total element count of a tree's tensor leaves."""
    return sum(t.numel() for t in T.tensors(tree))


def live_bytes(tree: Any) -> int:
    """Total bytes of a tree's tensor leaves at their dtypes."""
    return sum(t.numel() * t.element_size() for t in T.tensors(tree))


def ebft_live_block_bytes(block_params: Any, mask_params: Any,
                          n_moments: int = 2) -> int:
    """Live bytes while one block fine-tunes: weights + masks + f32 Adam
    moments — the quantity the paper's 16 GB claim bounds."""
    return (live_bytes(block_params) + live_bytes(mask_params)
            + n_moments * param_count(block_params) * 4)


def is_abstract(*values: Any) -> bool:
    """True under ``torch.compile``'s tracing or when a tensor of
    ``values`` is a meta tensor (no data: nothing to time). The port
    traces nothing today, so this is a guard only."""
    return torch.compiler.is_compiling() or any(t.is_meta for t in T.tensors(values))


def _sig(x: Any) -> Any:
    """Hashable signature: tensor shapes, dtypes, devices; other leaves by type."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return ("d",) + tuple((k, _sig(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_sig(v) for v in x)
    return ("v", type(x).__name__)


# ---------------------------------------------------------------------------
class DispatchLedger:
    """Counts device dispatches and host-sync events for one region.

    A *dispatch* is one unit of work the host enqueues (the reference: one
    jitted-executable launch; each caller's docstring says what it counts
    in the port); a *host sync* is one device→host read the host blocks on
    (``float(x)``, ``.item()``, a synchronise). The ledger is a plain
    counter pair — always live, so ``BlockReport`` carries real numbers
    even with observability off — and mirrors into the metrics registry
    when one is installed. ``devices`` books every dispatch per
    participating device under ``<name>/device_dispatches`` (the EBFT
    walk's ``plan.device_count`` on a mesh, ``core/ebft.py``; else 1).
    """

    __slots__ = ("name", "dispatches", "host_syncs", "devices")

    def __init__(self, name: str, devices: int = 1):
        self.name = name
        self.dispatches = 0
        self.host_syncs = 0
        self.devices = max(int(devices), 1)

    @property
    def device_dispatches(self) -> int:
        return self.dispatches * self.devices

    def dispatch(self, n: int = 1) -> None:
        self.dispatches += n
        M.counter(f"{self.name}/dispatches").inc(n)
        M.counter(f"{self.name}/device_dispatches").inc(n * self.devices)

    def host_sync(self, n: int = 1) -> None:
        self.host_syncs += n
        M.counter(f"{self.name}/host_syncs").inc(n)


# ---------------------------------------------------------------------------
# kernel launches: (name, flops, bytes, device, start event, end event, stream)
_PENDING: List[Tuple[str, float, float, torch.device, Any, Any, Any]] = []
# past this many unresolved pairs, a launch books those whose end event has
# completed (a query, no synchronise), so a loop that never flushes (a
# training run) holds no more pairs than the card's queue is deep
_PENDING_CAP = 1024


def _book(name: str, flops: float, bytes_moved: float, dt: float) -> None:
    M.histogram(f"{name}/exec_s").observe(dt)
    M.counter(f"{name}/calls").inc()
    M.counter(f"{name}/flops").inc(flops)
    M.counter(f"{name}/bytes").inc(bytes_moved)
    # ideal time on the card: the larger of the compute and memory terms
    M.gauge(f"{name}/roofline_ideal_s").set(max(flops / PEAK_FLOPS, bytes_moved / HBM_BW))


def record_kernel(name: str, flops: float, bytes_moved: float, fn: Callable, *args,
                  device: torch.device, plan: Optional[Dict[str, Any]] = None, **kw):
    """Run ``fn(*args, **kw)``, the launch of one kernel on ``device``, and
    book it against the roofline: on the card through a CUDA event pair on
    the current stream, resolved later by :func:`flush_kernels`; on the
    CPU by the host clock, at once. ``plan`` (the tuner's: ``plan`` and the
    tiles) opens an unfenced span ``name`` with it as attributes around the
    launch. Callers guard with ``trace.enabled() and not is_abstract(...)``."""
    if plan:
        with OT.span(name, **plan):
            return record_kernel(name, flops, bytes_moved, fn, *args, device=device, **kw)
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _book(name, flops, bytes_moved, time.perf_counter() - t0)
        return out
    stream = torch.cuda.current_stream(device)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record(stream)
    out = fn(*args, **kw)
    e1.record(stream)
    _PENDING.append((name, flops, bytes_moved, device, e0, e1, stream))
    if len(_PENDING) > _PENDING_CAP:
        _book_completed()
    return out


def _book_completed() -> None:
    """Book the pending pairs whose end event has completed, without
    synchronising, and keep the others in order. A stream's pairs complete
    in order, so each stream's scan stops at its first pair still in the
    queue; pairs on two streams (the EBFT walk's prefetched teacher beside
    the tuning) complete out of order, so one stream's does not hold back
    the other's."""
    left, blocked, streams = [], set(), {p[6] for p in _PENDING}
    for i, pair in enumerate(_PENDING):
        if len(blocked) == len(streams):
            left += _PENDING[i:]
            break
        name, flops, bytes_moved, _, e0, e1, stream = pair
        if stream not in blocked and e1.query():
            _book(name, flops, bytes_moved, e0.elapsed_time(e1) / 1e3)
        else:
            blocked.add(stream)
            left.append(pair)
    _PENDING[:] = left


def flush_kernels() -> int:
    """Synchronise the devices with pending event pairs, book each launch
    and clear the list; returns the number booked."""
    if not _PENDING:
        return 0
    pending = list(_PENDING)
    _PENDING.clear()
    for dev in {p[3] for p in pending}:
        torch.cuda.synchronize(dev)
    for name, flops, bytes_moved, _, e0, e1, _ in pending:
        _book(name, flops, bytes_moved, e0.elapsed_time(e1) / 1e3)
    return len(pending)


def kernel_time() -> Tuple[float, int]:
    """(seconds, launches) booked under ``kernels/*`` so far in the live
    run, after resolving the pending pairs: call it where the device has
    just been synchronised (a phase's end), and take differences."""
    flush_kernels()
    hists = [v for k, v in M.summary().items()
             if k.startswith("kernels/") and k.endswith("/exec_s")]
    return sum(h["sum"] for h in hists), sum(h["count"] for h in hists)


def drop_pending_kernels() -> None:
    """Forget unresolved pairs (a run that ends must not leave them to the next)."""
    _PENDING.clear()


# ---------------------------------------------------------------------------
class ProfiledFn:
    """Wraps a step; separates the first call per signature from the rest.

    Per argument signature (tensor shapes, dtypes, devices) the first call
    is fenced and booked as ``<name>/compile_s`` (a gauge, as the
    reference's) and ``<name>/compiles``; later calls are fenced into the
    ``<name>/exec_s`` histogram and ``<name>/calls``. After the fence the
    card is idle, so the kernels' pending event pairs are resolved there.
    """

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self._seen: set = set()

    def __call__(self, *args):
        if not OT.enabled() or is_abstract(*args):
            return self.fn(*args)
        sig = _sig(args)
        t0 = time.perf_counter()
        out = OT.fence(self.fn(*args))
        dt = time.perf_counter() - t0
        flush_kernels()
        if sig in self._seen:
            M.histogram(f"{self.name}/exec_s").observe(dt)
            M.counter(f"{self.name}/calls").inc()
        else:
            self._seen.add(sig)
            M.gauge(f"{self.name}/compile_s").set(dt)
            M.counter(f"{self.name}/compiles").inc()
        return out


def profiled(fn: Callable, name: str) -> ProfiledFn:
    """Wrap ``fn`` with first-call/steady-state profiling."""
    return ProfiledFn(fn, name)


# ---------------------------------------------------------------------------
# first-call attribution for the walk-phase histograms
# ---------------------------------------------------------------------------
class CompileClock:
    """Accumulates first-call wall time booked by :class:`FirstCallTimer`;
    a consumer (the EBFT walk) ``take()``s the pending total per phase so
    phase histograms can report steady state and first calls separately
    (``ebft/walk/{phase}_s`` vs ``{phase}_compile_s``)."""

    __slots__ = ("_pending",)

    def __init__(self) -> None:
        self._pending = 0.0

    def add(self, dt: float) -> None:
        self._pending += dt

    def take(self) -> float:
        dt, self._pending = self._pending, 0.0
        return dt


_CLOCK = CompileClock()


def compile_clock() -> CompileClock:
    """The process-wide clock the walk drains between phases."""
    return _CLOCK


class FirstCallTimer:
    """Times the host part of the first call per argument signature and
    books it on the :class:`CompileClock`, without fencing: a warm call
    returns once its launches are queued, while the first one also pays
    the one-time host work (a kernel library's load, cuBLAS handles and
    heuristics for a new shape). Adding no synchronise keeps the walk's
    queue as it is."""

    __slots__ = ("fn", "_seen")

    def __init__(self, fn: Callable):
        self.fn = fn
        self._seen: set = set()

    def __call__(self, *args, **kw):
        if not OT.enabled():
            return self.fn(*args, **kw)
        sig = _sig((args, kw))
        if sig in self._seen:
            return self.fn(*args, **kw)
        self._seen.add(sig)
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        _CLOCK.add(time.perf_counter() - t0)
        return out
