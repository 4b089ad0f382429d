"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``), on the CPU at tiny sizes.

What is held, and how:
- null mode records nothing (no span, no metric, no pending event pair);
- spans nest, unwind on an exception and time monotonically;
- metric summaries equal ``repro.obs.metrics``'s exactly for the same calls;
- artifacts round-trip through either package's readers and CLIs, and the
  two ``validate_payload``s give the same verdicts;
- the kernel wrappers' FLOP/byte accounting equals the reference
  wrappers' on the same shapes and dtypes (the attention backward: 2.5 ×
  the forward's FLOPs);
- on the card a launch is bracketed by CUDA events and nothing
  synchronises until the payload is assembled (rehearsed here with a
  host-clock stand-in for ``torch.cuda.Event``);
- the pipeline's artifact passes the reference's validator, carries the
  span tree and metrics of the reference's, and its per-block dispatch
  ledger equals the reference's legacy path on the same inputs; with
  ``--no-obs`` the results are bit for bit the same.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread_module  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.data import tokens as RTOK
from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.masked_matmul.ops import masked_matmul as ref_masked_matmul
from repro.kernels.nm_spmm.ops import nm_spmm as ref_nm_spmm
from repro.models.model import build as ref_build
from repro.obs import metrics as ROM
from repro.obs import trace as ROT
from repro.obs.__main__ import main as ref_obs_cli
from repro.obs.profile import ebft_live_block_bytes as ref_live_block_bytes
from repro.obs.run import current_run as ref_current_run
from repro.obs.run import start_run as ref_start_run
from repro.obs.run import validate_payload as ref_validate
from repro.obs.sinks import read_jsonl as ref_read_jsonl
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import ebft as EBFT
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.nm_spmm import ops as NM
from repro_torch.launch import ebft_run
from repro_torch.launch import train as TRAIN
from repro_torch.launch.rooflines import HBM_BW, PEAK_FLOPS
from repro_torch.models.model import build
from repro_torch.obs import metrics as OM
from repro_torch.obs import profile as P
from repro_torch.obs import trace as OT
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.obs.run import current_run, start_run, validate_payload
from repro_torch.obs.sinks import load_artifact, read_jsonl

REQUIRE = ["blocks", "phases", "perplexity", "ebft", "dispatch", "walk_phases", "mesh",
           "kernel_tuning"]
TINY_ARGV = ["--arch", "tiny_dense", "--pretrain-steps", "30", "--batch", "8", "--seq", "32",
             "--calib-samples", "8", "--epochs", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _obs_reset():
    """Every test starts and ends with both packages' null singletons
    installed and no pending kernel event pair."""
    for tr, reg in ((OT, OM), (ROT, ROM)):
        tr.set_tracer(None)
        reg.set_registry(None)
    P.drop_pending_kernels()
    yield
    for cur in (current_run(), ref_current_run()):
        if cur is not None:
            cur.finish()
    for tr, reg in ((OT, OM), (ROT, ROM)):
        tr.set_tracer(None)
        reg.set_registry(None)
    P.drop_pending_kernels()


# ---------------------------------------------------------------------------
# null mode
# ---------------------------------------------------------------------------
def test_null_mode_no_events_no_state():
    assert not OT.enabled() and not OM.enabled()
    with OT.span("outer", a=1) as sp:
        with OT.span("inner") as inner:
            assert inner is sp is OT.NULL_SPAN
        sp.set(b=2)
        assert sp.fence(42) == 42
    OM.counter("c").inc(5)
    OM.gauge("g").set(3.0)
    OM.histogram("h").observe(1.0)
    OM.series("s").append(1.0, step=0)
    x = torch.randn(8, 16)
    w = torch.randn(16, 8)
    MM.masked_matmul(x, w, torch.ones(16, 8, dtype=torch.bool))
    assert OT.get_tracer().tree() == [] and OM.summary() == {}
    assert sp.duration == 0.0 and sp.attrs == {}
    assert len(P._PENDING) == 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
def test_span_nesting_and_timing_monotonicity():
    run = start_run("t", device="cpu", console=False)
    with OT.span("walk", epochs=2) as w:
        with OT.span("block", index=0):
            time.sleep(0.001)
        with OT.span("block", index=1) as b1:
            with OT.span("step"):
                time.sleep(0.001)
            b1.set(loss=0.5)
    forest = run.tracer.tree()
    assert [r["name"] for r in forest] == ["walk"]
    blocks = forest[0]["children"]
    assert [b["name"] for b in blocks] == ["block", "block"]
    assert blocks[1]["children"][0]["name"] == "step"
    assert blocks[1]["attrs"] == {"index": 1, "loss": 0.5}
    assert w.duration >= b1.duration >= b1.children[0].duration > 0.0
    assert blocks[1]["start"] >= blocks[0]["start"] + blocks[0]["duration_s"]
    for node in (forest[0], blocks[0], blocks[1]):
        assert node["duration_s"] >= sum(c["duration_s"] for c in node.get("children", []))
    run.finish()
    assert not OT.enabled() and current_run() is None


def test_span_stack_unwinds_on_exception():
    run = start_run("t", device="cpu", console=False)
    with pytest.raises(RuntimeError):
        with OT.span("outer"):
            with OT.span("inner"):
                raise RuntimeError("boom")
    with OT.span("after"):
        pass
    assert [r["name"] for r in run.tracer.tree()] == ["outer", "after"]
    assert [c["name"] for c in run.tracer.tree()[0]["children"]] == ["inner"]


def test_fence_is_identity_on_cpu_values():
    value = {"a": torch.ones(2), "b": [torch.zeros(1), (3, None)]}
    assert OT.fence(value) is value
    assert sorted(t.numel() for t in T.tensors(value)) == [1, 2]


# ---------------------------------------------------------------------------
# metrics: the same calls give the reference's summaries
# ---------------------------------------------------------------------------
_CALLS = [
    [("counter", "tokens", "inc", 3), ("counter", "tokens", "inc", 2.5)],
    [("gauge", "live", "set", v) for v in (10.0, 50, 20.0)],
    [("histogram", "lat", "observe", v) for v in (4.0, 1.0, 3.0, 2.0, 7.5)],
    [("series", "loss", "append", 2.0), ("series", "loss", "append", 1.0),
     ("series", "loss", "append", 0.5)],
    [("histogram", "empty", None, None), ("gauge", "g0", None, None),
     ("series", "s0", None, None)],
]


@pytest.mark.parametrize("calls", _CALLS, ids=["counter", "gauge", "histogram", "series",
                                                "untouched"])
def test_metric_summaries_equal_reference(calls):
    port, ref = OM.Metrics(), ROM.Metrics()
    events_port, events_ref = [], []
    port.add_emitter(events_port.append)
    ref.add_emitter(events_ref.append)
    for k, (kind, name, op, v) in enumerate(calls):
        for reg in (port, ref):
            inst = getattr(reg, kind)(name)
            if op == "append":
                inst.append(v, step=10 * k)
            elif op is not None:
                getattr(inst, op)(v)
    assert port.summary() == ref.summary()
    assert events_port == events_ref


def test_histogram_reservoir_and_percentiles_equal_reference():
    port, ref = OM.Histogram("h"), ROM.Histogram("h")
    for v in np.random.default_rng(0).normal(size=5000):
        port.observe(float(v))
        ref.observe(float(v))
    assert port.summary() == ref.summary()
    assert len(port.samples) == 4096


def test_metrics_refuse_kind_mismatch_and_device_tensors():
    start_run("t", device="cpu", console=False)
    OM.counter("tokens").inc()
    with pytest.raises(TypeError):
        OM.gauge("tokens")

    class OnCard:  # stands in for a CUDA tensor: float() of it would synchronise
        is_cuda = True

        def __float__(self):
            raise AssertionError("read")

    for call in (lambda: OM.gauge("g").set(OnCard()), lambda: OM.counter("c").inc(OnCard()),
                 lambda: OM.histogram("h").observe(OnCard()),
                 lambda: OM.series("s").append(OnCard())):
        with pytest.raises(TypeError, match="host numbers"):
            call()
    OM.gauge("g").set(torch.tensor(2.0))  # a CPU tensor is a host number
    assert OM.summary()["g"]["max"] == 2.0


# ---------------------------------------------------------------------------
# sinks, the CLI and the schema
# ---------------------------------------------------------------------------
def test_jsonl_roundtrip_read_by_reference_and_both_clis(tmp_path, capsys):
    jsonl = tmp_path / "events.jsonl"
    summary = tmp_path / "BENCH_t.json"
    run = start_run("roundtrip", device="cpu", config="tiny_dense", method="wanda", sparsity=0.5,
                    console=False, jsonl_path=str(jsonl))
    with OT.span("phase/work", what="stuff", n=torch.tensor(3.0)):
        OM.counter("work/items").inc(7)
        OM.series("work/loss").append(torch.tensor(0.25), step=1)
    run.finish(extra={"answer": 42}, summary_path=str(summary))

    events = ref_read_jsonl(str(jsonl))
    assert events == read_jsonl(str(jsonl))
    assert events[0]["type"] == "manifest" and events[0]["manifest"]["name"] == "roundtrip"
    assert events[0]["manifest"]["jax_backend"] == "cpu"
    assert events[0]["manifest"]["device_count"] == 1
    span_ev = next(e for e in events if e["type"] == "span")
    assert span_ev["name"] == "phase/work" and span_ev["attrs"]["n"] == 3.0
    assert {"counter", "series", "span"} <= {e["type"] for e in events[1:]}

    for cli in (obs_cli, ref_obs_cli):
        for artifact in (str(summary), str(jsonl)):
            assert cli(["report", artifact]) == 0
            out = capsys.readouterr().out
            assert "roundtrip" in out and "phase/work" in out
        assert cli(["report", str(summary), "--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["answer"] == 42 and payload["metrics"]["work/items"]["value"] == 7.0
        assert cli(["validate", str(summary), "--require", "answer"]) == 0
        assert cli(["validate", str(jsonl)]) == 1
        assert cli(["report", str(tmp_path / "missing.json")]) == 2
        capsys.readouterr()
    assert load_artifact(str(jsonl))["manifest"]["name"] == "roundtrip"


def test_jsonable_reads_cpu_tensors():
    from repro_torch.obs.sinks import _jsonable

    assert _jsonable(torch.tensor(True)) is True and _jsonable(torch.tensor(1.5)) == 1.5
    t = torch.empty(2, device="meta")
    assert isinstance(_jsonable(t), str)  # not 0-d: its repr, as the reference's fallback


def _payloads():
    run = start_run("ok", device="cpu", console=False)
    ok = run.finish()
    return [
        (ok, {}),
        (ok, {"require": ["blocks"]}),
        (dict(ok, manifest=dict(ok["manifest"], schema="nope/v9")), {}),
        (dict(ok, manifest={k: v for k, v in ok["manifest"].items() if k != "jax_backend"}), {}),
        (dict(ok, manifest=dict(ok["manifest"], device_count="1")), {}),
        ({"metrics": {}, "trace": []}, {}),
        ([1, 2], {}),
        (ok, {"max_dispatches_per_block": 4}),
        (dict(ok, dispatch={"per_block_max": 3}), {"max_dispatches_per_block": 4}),
        (dict(ok, dispatch={"per_block_max": 9}), {"max_dispatches_per_block": 4}),
        (dict(ok, dispatch={"per_block_max": "lots"}), {"max_dispatches_per_block": 4}),
        (dict(ok, kernel_tuning={"mode": "off", "cache_path": None, "hits": 0, "misses": 0,
                                 "searches": 0, "search_s": 0.0}), {"require_cache_hits": True}),
        (dict(ok, kernel_tuning={"hits": 2, "misses": 0, "searches": 0, "search_s": 0.0}),
         {"require_cache_hits": True}),
    ]


def test_validate_payload_agrees_with_reference():
    for payload, kw in _payloads():
        assert validate_payload(payload, **kw) == ref_validate(payload, **kw), (payload, kw)
    ok = _payloads()[0][0]
    assert validate_payload(ok) == [] and set(ok["manifest"]) >= {
        "device_name", "torch_version", "cuda_version"}


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_profiled_fn_books_once_per_signature():
    start_run("t", device="cpu", console=False)
    calls = []
    f = P.profiled(lambda x, k: calls.append(k) or x * 2.0, "test/step")
    x = torch.arange(8.0)
    for k in range(3):
        out = f(x, k)
    assert torch.equal(out, x * 2.0) and calls == [0, 1, 2]
    s = OM.summary()
    assert s["test/step/compiles"]["value"] == 1.0  # ints count by type
    assert s["test/step/compile_s"]["last"] >= 0.0
    assert s["test/step/exec_s"]["count"] == 2 and s["test/step/calls"]["value"] == 2.0
    f(torch.arange(4.0), 0)
    f(torch.arange(4, dtype=torch.float64), 0)
    assert OM.summary()["test/step/compiles"]["value"] == 3.0


def test_profiled_fn_passthrough_when_disabled_or_abstract():
    f = P.profiled(lambda x: x + 1.0, "test/off")
    assert float(f(torch.tensor(1.0))) == 2.0
    start_run("t", device="cpu", console=False)
    assert f(torch.empty(3, device="meta")).is_meta
    assert "test/off/exec_s" not in OM.summary() and "test/off/compiles" not in OM.summary()
    assert P.is_abstract({"a": [torch.empty(1, device="meta")]})
    assert not P.is_abstract(torch.ones(1), {"a": 1.0})


def test_first_call_timer_books_once_per_signature():
    start_run("t", device="cpu", console=False)
    clock = P.compile_clock()
    clock.take()
    timed = P.FirstCallTimer(lambda x, i: (time.sleep(0.002), x + i)[1])
    x = torch.arange(4.0)
    timed(x, i=0)
    assert clock.take() > 0.0
    timed(x, i=1)  # another value of the same type: the same signature
    assert clock.take() == 0.0
    timed(x.double(), i=0)
    assert clock.take() > 0.0
    assert clock.take() == 0.0


def test_first_call_timer_passthrough_when_disabled():
    clock = P.compile_clock()
    clock.take()
    timed = P.FirstCallTimer(lambda x: x * 2.0)
    assert float(timed(torch.tensor(3.0))) == 6.0
    assert clock.take() == 0.0


def test_dispatch_ledger_counts_and_mirrors():
    start_run("t", device="cpu", console=False)
    led = P.DispatchLedger("ebft/tune")
    led.dispatch(3)
    led.dispatch()
    led.host_sync()
    assert (led.dispatches, led.host_syncs, led.device_dispatches) == (4, 1, 4)
    s = OM.summary()
    assert s["ebft/tune/dispatches"]["value"] == 4.0
    assert s["ebft/tune/device_dispatches"]["value"] == 4.0
    assert s["ebft/tune/host_syncs"]["value"] == 1.0


def test_live_block_bytes_equals_reference_on_carried_weights():
    model = ref_build(ref_get_config("tiny_dense"))
    params = model.init(jax.random.PRNGKey(0))
    block = jax.tree.map(np.asarray, model.get_block(params, 0))
    masks = jax.tree.map(lambda a: (np.abs(a) > 0.01).astype(np.float32), block)
    port_w = interop.params_to_torch(block, "cpu")
    port_m = interop.params_to_torch(masks, "cpu")  # f32, as the reference's
    assert P.ebft_live_block_bytes(port_w, port_m) == ref_live_block_bytes(block, masks)
    assert P.param_count(port_w) == sum(a.size for a in jax.tree.leaves(block))
    bool_m = interop.masks_to_torch(masks, "cpu")  # the port's masks: one byte a slot
    assert P.live_bytes(bool_m) == sum(a.size for a in jax.tree.leaves(masks))


@pytest.mark.parametrize("arch", ["tiny_dense", "llama_7b"])
def test_model_flops_equal_reference(arch):
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.rooflines import model_flops_per_chip as ref_model_flops
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.rooflines import model_flops_per_chip

    for kind, seq, batch, chips in (("train", 128, 32, 1), ("prefill", 2048, 8, 4),
                                    ("decode", 2048, 16, 1), ("ebft", 2048, 8, 1)):
        assert model_flops_per_chip(get_config(arch), ShapeConfig("s", seq, batch, kind), chips) \
            == ref_model_flops(ref_get_config(arch), RefShape("s", seq, batch, kind), chips)


# ---------------------------------------------------------------------------
# the kernel wrappers' accounting
# ---------------------------------------------------------------------------
def _counters(summary, name):
    return {k: summary[f"{name}/{k}"]["value"] for k in ("calls", "flops", "bytes")}


def _ref_summary(fn):
    run = ref_start_run("ref", console=False)
    jax.block_until_ready(fn())
    return run.finish()["metrics"]


def test_kernel_accounting_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 32)).astype(np.float32)
    w = rng.normal(size=(32, 40)).astype(np.float32)
    m = (rng.random((32, 40)) < 0.3).astype(np.float32)
    q, k, v = (rng.normal(size=(6, 16, 8)).astype(np.float32) for _ in range(3))
    vals = rng.normal(size=(16, 40)).astype(np.float32)
    idx = np.stack([np.sort(rng.permutation(4)[:2]) for _ in range(8 * 40)]).reshape(
        8, 40, 2).transpose(0, 2, 1).reshape(16, 40).astype(np.int8)
    ref = _ref_summary(lambda: (ref_masked_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m)),
                                ref_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                    jnp.asarray(v), causal=True),
                                ref_nm_spmm(jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx),
                                            n=2, m=4)))
    run = start_run("port", device="cpu", console=False)
    t = torch.from_numpy
    MM.masked_matmul(t(x), t(w), t(m))
    FA.flash_attention(t(q), t(k), t(v), causal=True)
    NM.nm_spmm(t(x), t(vals), t(idx), n=2, m=4)
    port = run.finish()["metrics"]
    for name in ("kernels/masked_matmul", "kernels/flash_attention", "kernels/nm_spmm"):
        assert _counters(port, name) == _counters(ref, name), name
        assert port[f"{name}/roofline_ideal_s"]["last"] == pytest.approx(
            max(port[f"{name}/flops"]["value"] / PEAK_FLOPS,
                port[f"{name}/bytes"]["value"] / HBM_BW), rel=1e-12)
        assert port[f"{name}/exec_s"]["count"] == 1


def test_backward_kernels_are_booked_under_their_names():
    start_run("t", device="cpu", console=False)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(24, 32, generator=g, requires_grad=True)
    w = torch.randn(32, 40, generator=g, requires_grad=True)
    m = (torch.rand(32, 40, generator=g) < 0.5).float().requires_grad_(True)
    MM.masked_matmul(x, w, m).sum().backward()
    q, k, v = (torch.randn(6, 16, 8, generator=g, requires_grad=True) for _ in range(3))
    FA.flash_attention(q, k, v, causal=True).sum().backward()
    s = OM.summary()
    for op in ("dx", "dw", "dm"):
        c = _counters(s, f"kernels/masked_matmul_{op}")
        assert c["calls"] == 1 and c["flops"] == 2.0 * 24 * 32 * 40
    assert s["kernels/masked_matmul_dx/bytes"]["value"] == 4 * (24 * 40 + 2 * 32 * 40 + 24 * 32)
    fwd, bwd = (_counters(s, n) for n in ("kernels/flash_attention", "kernels/flash_attention_bwd"))
    assert fwd["calls"] == bwd["calls"] == 1
    assert bwd["flops"] == 2.5 * fwd["flops"] == 2.5 * 4.0 * 6 * 16 * 16 * 8 * 0.5
    assert bwd["bytes"] == 4 * (2 * 3 * 6 * 16 * 8 + 2 * 6 * 16 * 8 + 6 * 16)


class _HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event`` (no card here)."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _HostEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def query(self):
        return self.t is not None and self.t <= _HostEvent.done_before


_HostEvent.done_before = float("inf")  # events recorded later count as still queued


def test_record_kernel_on_the_card_records_events_and_syncs_only_at_flush(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    dev = torch.device("cuda", 0)
    run = start_run("t", device="cpu", console=False)
    for _ in range(5):
        P.record_kernel("kernels/fake", 2.0e9, 4.0e6, lambda: time.sleep(0.001), device=dev)
    assert syncs == [] and len(P._PENDING) == 5 and _HostEvent.made == 10
    assert "kernels/fake/calls" not in OM.summary()  # booked only once resolved
    s = run.payload()["metrics"]
    assert syncs == [dev] and len(P._PENDING) == 0
    assert s["kernels/fake/calls"]["value"] == 5.0 and s["kernels/fake/flops"]["value"] == 1e10
    assert s["kernels/fake/exec_s"]["min"] >= 0.001
    assert s["kernels/fake/roofline_ideal_s"]["last"] == max(2.0e9 / PEAK_FLOPS, 4.0e6 / HBM_BW)
    P.record_kernel("kernels/fake", 1.0, 1.0, lambda: None, device=dev)
    run.finish()  # flushes the last pair and leaves none behind
    assert len(P._PENDING) == 0 and len(syncs) == 2
    P.record_kernel("kernels/fake", 1.0, 1.0, lambda: None, device=dev)
    run2 = start_run("t2", device="cpu", console=False)  # a new run starts with no stale pair
    assert len(P._PENDING) == 0
    assert "kernels/fake/calls" not in run2.finish()["metrics"]


def _fake_card(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    return syncs


def test_record_kernel_books_completed_pairs_past_the_cap_without_a_sync(monkeypatch):
    syncs = _fake_card(monkeypatch)
    monkeypatch.setattr(P, "_PENDING_CAP", 4)
    dev = torch.device("cuda", 0)
    run = start_run("t", device="cpu", console=False)
    for _ in range(4):
        P.record_kernel("kernels/fake", 1.0, 1.0, lambda: None, device=dev)
    monkeypatch.setattr(_HostEvent, "done_before", time.perf_counter())
    for _ in range(3):  # the first past the cap books the four completed pairs
        P.record_kernel("kernels/fake", 1.0, 1.0, lambda: None, device=dev)
    assert syncs == [] and len(P._PENDING) == 3
    assert OM.summary()["kernels/fake/calls"]["value"] == 4.0
    monkeypatch.setattr(_HostEvent, "done_before", float("inf"))
    assert run.finish()["metrics"]["kernels/fake/calls"]["value"] == 7.0
    assert len(P._PENDING) == 0 and syncs == [dev]


def test_profiled_fn_resolves_pending_pairs_after_its_fence(monkeypatch):
    _fake_card(monkeypatch)
    dev = torch.device("cuda", 0)
    start_run("t", device="cpu", console=False)
    step = P.profiled(lambda x: P.record_kernel("kernels/fake", 1.0, 1.0, lambda: x, device=dev),
                      "train/step")
    for _ in range(3):
        step(torch.ones(2))
        assert len(P._PENDING) == 0
    s = OM.summary()
    assert s["kernels/fake/calls"]["value"] == 3.0 and s["train/step/calls"]["value"] == 2.0


def test_start_run_needs_the_device():
    with pytest.raises(TypeError):
        start_run("t", console=False)


# ---------------------------------------------------------------------------
# the pipeline command (ebft_run)
# ---------------------------------------------------------------------------
def _count_plain_calls(monkeypatch):
    """The CPU's launches: the plain versions the wrappers call."""
    counts = {}
    for mod, attr, key in ((MM, "masked_matmul_plain", "masked_matmul"),
                           (MM, "masked_matmul_dx_plain", "masked_matmul_dx"),
                           (MM, "masked_matmul_dw_plain", "masked_matmul_dw"),
                           (MM, "masked_matmul_dm_plain", "masked_matmul_dm")):
        fn = getattr(mod, attr)
        counts[key] = 0

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return counts


def _console(text: str):
    """Console lines with the timings and the artifact line taken out."""
    return [re.sub(r"\(\d+s", "(_s", ln) for ln in text.splitlines() if not ln.startswith("wrote ")]


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """The tiny pipeline with obs on (artifact and JSONL) and with --no-obs."""
    tmp = tmp_path_factory.mktemp("obs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    try:
        counts = _count_plain_calls(mp)
        bench, jsonl = tmp / "BENCH_ebft.json", tmp / "events.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = ebft_run.main(TINY_ARGV + ["--bench-out", str(bench), "--obs-jsonl", str(jsonl)])
        on = dict(res=res, console=buf.getvalue(), counts=dict(counts), bench=bench, jsonl=jsonl)
        assert current_run() is None and not OT.enabled()
        buf = io.StringIO()
        off_bench = tmp / "off.json"
        with contextlib.redirect_stdout(buf):
            res_off = ebft_run.main(TINY_ARGV + ["--bench-out", str(off_bench), "--no-obs"])
        off = dict(res=res_off, console=buf.getvalue(), bench=off_bench)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return on, off


def test_pipeline_artifact_passes_the_reference_validator(pipeline_runs, capsys):
    on, _ = pipeline_runs
    payload = load_artifact(str(on["bench"]))
    assert ref_validate(payload, require=REQUIRE) == []
    assert validate_payload(payload, require=REQUIRE) == []
    m = payload["manifest"]
    assert (m["name"], m["config"], m["method"], m["jax_backend"]) == (
        "ebft_run", "tiny_dense", "wanda", "cpu")
    assert m["run_spec"]["kind"] == "ebft" and m["fused_epochs"] is True
    assert m["prefetch_depth"] == 1 and m["ebft_epochs"] == 2 and m["calib_samples"] == 8
    for cli in (obs_cli, ref_obs_cli):
        assert cli(["report", str(on["bench"])]) == 0
        out = capsys.readouterr().out
        assert "ebft/block" in out and "walk/teacher" in out
    events = ref_read_jsonl(str(on["jsonl"]))
    assert events[0]["manifest"]["name"] == "ebft_run"
    assert any(e.get("name") == "ebft/block" for e in events)
    assert "render with: python -m repro_torch.obs report" in on["console"]


def test_pipeline_trace_and_metrics(pipeline_runs):
    on, _ = pipeline_runs
    payload = load_artifact(str(on["bench"]))
    res = on["res"]
    roots = [s["name"] for s in payload["trace"]]
    assert roots == ["phase/kernel_tune", "phase/pretrain", "phase/eval", "phase/prune",
                     "phase/ebft", "phase/eval"]
    ebft_phase = payload["trace"][4]
    assert [c["name"] for c in ebft_phase["children"]] == ["ebft/walk"]
    walk = ebft_phase["children"][0]
    assert walk["attrs"]["fused"] is True and walk["attrs"]["prefetch_depth"] == 1
    names = [c["name"] for c in walk["children"]]
    assert names == ["walk/teacher", "walk/tune", "walk/student"] * len(res.reports)
    tunes = [c for c in walk["children"] if c["name"] == "walk/tune"]
    for blk, t in enumerate(tunes):
        assert [g["name"] for g in t["children"]] == ["ebft/block"]
        assert t["children"][0]["attrs"]["index"] == blk == t["attrs"]["block"]
    metrics = payload["metrics"]
    assert metrics["ebft/live_block_bytes"]["max"] == payload["ebft"]["peak_live_block_bytes"]
    assert payload["ebft"]["peak_live_block_bytes"] == max(r.live_bytes for r in res.reports)
    assert metrics["kernels/masked_matmul/calls"]["value"] == on["counts"]["masked_matmul"] > 0
    for op in ("dx", "dw"):
        assert metrics[f"kernels/masked_matmul_{op}/calls"]["value"] == \
            on["counts"][f"masked_matmul_{op}"] > 0
    assert metrics["pretrain/loss"]["n"] == len(res.pretrain_losses) == 3
    assert metrics["ebft/loss_before"]["points"] == [
        [float(r.index), r.loss_before] for r in res.reports]
    n_blocks = len(res.reports)
    # the stacked walk's units, the reference's: 4 per segment setup, one
    # per stacked advance of a stream; one host sync per teacher wait
    assert payload["dispatch"]["walk_total"] == 4 + 2 * n_blocks
    assert payload["dispatch"]["walk_host_syncs"] == n_blocks
    for p in ("teacher", "tune", "student"):
        assert payload["walk_phases"][p] > 0 and payload["walk_phases"][f"{p}_compile"] >= 0
    assert metrics["ebft/walk/tune_s"]["count"] == n_blocks
    assert payload["mesh"] == {"devices": 1, "axes": {}, "active": False,
                               "peak_live_block_bytes_per_shard":
                                   payload["ebft"]["peak_live_block_bytes"],
                               "collective_bytes_total": 0}
    assert payload["kernel_tuning"]["mode"] == "cache"
    assert payload["dispatch"]["fused_all_blocks"] is True
    assert payload["dispatch"]["per_block_max"] == payload["dispatch"]["tune_per_block_max"] + 2
    for b, r in zip(payload["blocks"], res.reports):
        assert b["device_dispatches"] == b["dispatches"] == r.dispatches
        assert b["live_bytes_per_shard"] == b["live_bytes"] and b["collective_bytes"] == 0


def test_pipeline_dispatch_ledger_equals_reference_legacy_path(pipeline_runs):
    """The port's per-epoch loop (``fused_epochs=False``) books the
    reference's legacy ledger on the pipeline's weights, and the pipeline's
    own blocks (the default, fused) the reference's default's."""
    on, _ = pipeline_runs
    res = on["res"]
    model = ref_build(ref_get_config("tiny_dense"))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=model.cfg.vocab_size, seed=0))
    calib = RTOK.calibration_set(corpus, 8, 32)
    dense = jax.tree.map(jnp.asarray, interop.params_to_numpy(res.dense))
    pruned = jax.tree.map(jnp.asarray, interop.params_to_numpy(res.pruned))
    masks = jax.tree.map(lambda m, w: jnp.broadcast_to(jnp.asarray(m, jnp.float32), w.shape),
                         interop.masks_to_numpy(res.masks), dense)
    _, ref_reports = REBFT.finetune(model, dense, pruned, masks, calib,
                                    REBFT.EBFTConfig(lr=1e-2, epochs=2, fused_epochs=False))
    _, legacy = EBFT.finetune(build(get_config("tiny_dense")), res.dense,
                              res.pruned, res.masks, calib,
                              EBFT.EBFTConfig(lr=1e-2, epochs=2, fused_epochs=False))
    assert [r.path for r in ref_reports] == [r.path for r in legacy] == \
        ["legacy"] * len(res.reports)
    assert [(r.epochs_run, r.early_stop) for r in legacy] == [
        (r.epochs_run, r.early_stop) for r in ref_reports]
    assert [(r.dispatches, r.host_syncs) for r in legacy] == [
        (r.dispatches, r.host_syncs) for r in ref_reports]
    _, ref_fused = REBFT.finetune(model, dense, pruned, masks, calib,
                                  REBFT.EBFTConfig(lr=1e-2, epochs=2))
    assert [(r.path, r.epochs_run, r.early_stop, r.dispatches, r.host_syncs)
            for r in res.reports] == [(r.path, r.epochs_run, r.early_stop, r.dispatches,
                                       r.host_syncs) for r in ref_fused]


def test_no_obs_gives_the_same_results_and_no_artifact(pipeline_runs):
    on, off = pipeline_runs
    assert not off["bench"].exists()
    assert _console(off["console"]) == _console(on["console"])
    assert off["res"].perplexity == on["res"].perplexity
    for a, b in zip(T.tensors(on["res"].tuned), T.tensors(off["res"].tuned)):
        assert torch.equal(a, b)
    assert [r.asdict() for r in off["res"].reports] == [r.asdict() for r in on["res"].reports]


def test_bench_record_without_a_run_leaves_the_metric_sections_empty(pipeline_runs):
    on, _ = pipeline_runs
    spec = ebft_run.RunSpec(pretrain_steps=30, batch=8, seq=32, calib_samples=8, epochs=2)
    rec = ebft_run.bench_record(spec, on["res"])
    assert set(REQUIRE) <= set(rec)
    assert rec["dispatch"]["walk_total"] is None
    assert all(v is None for v in rec["walk_phases"].values())


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------
def test_train_cli_writes_the_trained_section(tmp_path, capsys):
    bench = tmp_path / "BENCH_train.json"
    res = TRAIN.main(["--steps", "12", "--batch", "4", "--seq", "32", "--device", "cpu",
                      "--bench-out", str(bench)])
    out = capsys.readouterr().out
    assert "12 steps in" in out
    payload = load_artifact(str(bench))
    assert ref_validate(payload, require=["trained"]) == []
    tr = payload["trained"]
    assert tr["steps"] == 12 and tr["history"] == [list(h) for h in res.history]
    assert tr["steps_per_s"] == pytest.approx(12 / tr["seconds"])
    m = payload["metrics"]
    assert m["train/loss"]["points"] == [[float(s), loss] for s, loss in res.history]
    assert m["train/grad_norm"]["n"] == len(res.history) == 2
    assert m["train/steps"]["value"] == 12.0
    assert m["train/step/compiles"]["value"] == 1.0 and m["train/step/calls"]["value"] == 11.0
    assert [s["name"] for s in payload["trace"]] == ["train/run"]
    assert payload["manifest"]["run_spec"]["kind"] == "train"
    TRAIN.main(["--steps", "2", "--batch", "4", "--seq", "32", "--device", "cpu", "--no-obs",
                "--bench-out", str(tmp_path / "off.json")])
    assert not (tmp_path / "off.json").exists()
