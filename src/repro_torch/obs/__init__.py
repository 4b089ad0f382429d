"""repro_torch.obs — tracing, metrics and profiling for the port (port of
``repro.obs``; the artifacts are the reference's schema, ``repro.obs/v1``,
and either package's CLI reads either's).

  * :mod:`repro_torch.obs.trace`   — nested wall-time spans; ``fence``
    synchronises the device of a value's CUDA tensors inside the span::

        from repro_torch.obs import trace
        with trace.span("ebft/block", index=i) as sp:
            out = sp.fence(step(...))

  * :mod:`repro_torch.obs.metrics` — counters, gauges, histograms and
    time-series with a JSON summary and a JSONL event stream; they take
    host numbers only.

  * :mod:`repro_torch.obs.profile` — first-call vs steady-state timing of
    a step, per-launch kernel accounting against the H100 roofline
    (``launch/rooflines.py``) through CUDA event pairs resolved when the
    run's payload is assembled, and tree byte/param accounting for the
    paper's live-block-memory claim.

Everything is off by default: the module-level tracer and registry are
null singletons whose methods allocate nothing, so the instrumented paths
cost one check until :func:`repro_torch.obs.run.start_run` swaps in live
objects.

``python -m repro_torch.obs report <artifact>`` renders a run's trace tree
and metric summaries; ``... validate`` checks the manifest schema.
"""
from __future__ import annotations

from repro_torch.obs import metrics, profile, trace  # noqa: F401  (public facades)
from repro_torch.obs.run import Run, current_run, start_run  # noqa: F401


def enabled() -> bool:
    """True when a live run is collecting (the null tracer reports False)."""
    return trace.enabled()
