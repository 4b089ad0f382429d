"""The port's serving path held against the reference on the CPU: the KV
cache (``init_cache``, ``prefill``, ``decode_step``), ``Server.generate``,
continuous batching (``Server.serve``) and ``launch/serve.py``, on
tiny_dense weights carried across from the reference's init in f32.

Stated tolerances: logits and cache contents rtol = atol = 1e-5 (f32; the
two sides sum in another order), ``len`` exact; greedy tokens equal token
for token. The port keeps its cache as (L, B, Hkv, max_len, hd); it is
compared with the reference's (L, B, max_len, Hkv, hd) after a permute.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs import get_config as ref_get_config
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig as RCorpusConfig
from repro.data.tokens import SyntheticCorpus as RSyntheticCorpus
from repro.data.tokens import calibration_set as ref_calibration_set
from repro.launch import serve as RSERVE
from repro.models.model import build as ref_build
from repro.obs import metrics as ROM
from repro.obs import trace as ROT
from repro.obs.run import validate_payload as ref_validate
from repro.serving.decode import Request as RRequest
from repro.serving.decode import Server as RServer
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.masks import prune
from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro_torch.launch import serve as SERVE
from repro_torch.models.model import build
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.run import validate_payload
from repro_torch.serving.decode import Request, Server

TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_NAMES = ["serve/prefill/compile_s", "serve/decode/exec_s", "serve/queue_depth",
               "serve/batch_occupancy", "serve/tokens", "serve/requests",
               "serve/tokens_per_s"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    under several test workers on few cores the threads' waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_reset():
    for tr, reg in ((OT, OM), (ROT, ROM)):
        tr.set_tracer(None)
        reg.set_registry(None)
    yield
    for tr, reg in ((OT, OM), (ROT, ROM)):
        tr.set_tracer(None)
        reg.set_registry(None)


def _pair(**overrides):
    """(reference model, its params, port model, the same params) for
    tiny_dense with ``overrides``."""
    rcfg = ref_get_config("tiny_dense").replace(**overrides)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = interop.params_to_torch(jax.tree.map(np.asarray, rparams), "cpu")
    return rmodel, rparams, build(get_config("tiny_dense").replace(**overrides)), params


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _np(x):
    return np.asarray(x, np.float32)


def _check_state(state, rstate):
    assert state["len"] == int(rstate["len"])
    for name in ("k", "v"):
        np.testing.assert_allclose(state[name].permute(0, 1, 3, 2, 4).numpy(),
                                   _np(rstate[name]), **TOL)


def _prompts(seed, lengths, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lengths]


def _requests(cls, seed, n, lengths, max_new):
    prompts = _prompts(seed, [lengths(i) for i in range(n)])
    return [cls(uid=i, prompt=p, max_new=max_new(i)) for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# the KV cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl,chunk,hkv", [
    ("dot", 1024, 4), ("chunked", 5, 4), ("flash", 5, 4), ("chunked", 1024, 2),
])
def test_prefill_and_decode_match_reference(impl, chunk, hkv):
    """Prefill then six decode steps (teacher-forced tokens): each step's
    logits, the whole cache and ``len`` against the reference. On the CPU
    the reference's cache branch takes its chunked path for "flash" and
    "chunked"; a chunk of 5 does not divide ``max_len`` 16 (the
    reference pads its keys), and hkv 2 is grouped-query attention."""
    rmodel, rparams, model, params = _pair(attn_impl=impl, attn_chunk=chunk, num_kv_heads=hkv)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    state = model.init_serve_state(2, 16, "cpu")
    rstate = rmodel.init_serve_state(2, 16)
    logits, state = model.prefill(params, {"tokens": torch.as_tensor(toks)}, state)
    rlogits, rstate = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)}, rstate)
    assert logits.shape == (2, 1, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(rlogits), **TOL)
    _check_state(state, rstate)
    for _ in range(6):
        tok = rng.integers(0, 500, size=(2, 1)).astype(np.int32)
        logits, state = model.decode_step(params, torch.as_tensor(tok), state)
        rlogits, rstate = rmodel.decode_step(rparams, jnp.asarray(tok), rstate)
        np.testing.assert_allclose(logits.numpy(), _np(rlogits), **TOL)
        _check_state(state, rstate)
    assert state["len"] == 13


@pytest.mark.parametrize("impl", ["dot", "chunked"])
def test_prefill_then_decode_equals_forward(tiny, impl):
    """The cached path's logits are the no-cache forward's at the last
    position (the forward over the prompt and the decoded tokens)."""
    _, _, _, params = tiny
    model = build(get_config("tiny_dense").replace(attn_impl=impl))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 512, size=(3, 12)))
    state = model.init_serve_state(3, 20, "cpu")
    logits, state = model.prefill(params, {"tokens": toks[:, :9]}, state)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               model.forward(params, {"tokens": toks[:, :9]})[:, -1].numpy(),
                               **TOL)
    for t in range(9, 12):
        logits, state = model.decode_step(params, toks[:, t:t + 1], state)
        full = model.forward(params, {"tokens": toks[:, :t + 1]})[:, -1]
        np.testing.assert_allclose(logits[:, 0].numpy(), full.numpy(), **TOL)


def test_write_past_the_cache_clamps_as_the_reference():
    """``len`` past ``max_len - S``: the write is clamped into range (as
    ``lax.dynamic_update_slice``), the causal offset is not."""
    rmodel, rparams, model, params = _pair()
    toks = np.random.default_rng(4).integers(0, 500, size=(2, 6)).astype(np.int32)
    state = model.init_serve_state(2, 8, "cpu")
    rstate = rmodel.init_serve_state(2, 8)
    for sl in (slice(0, 6), slice(0, 3), slice(3, 4), slice(4, 6)):
        logits, state = model.prefill(params, {"tokens": torch.as_tensor(toks[:, sl])}, state)
        rlogits, rstate = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks[:, sl])}, rstate)
        np.testing.assert_allclose(logits.numpy(), _np(rlogits), **TOL)
        _check_state(state, rstate)
    assert state["len"] == 12 > 8


def test_serve_state_needs_the_card_unless_asked_for_the_cpu(tiny):
    _, _, model, _ = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_serve_state(1, 8)
    assert model.init_serve_state(1, 8, "cpu")["k"].shape == (2, 1, 4, 8, 16)


# ---------------------------------------------------------------------------
# Server.generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", [(16, 16, 16), (16, 9, 12, 5)])
@pytest.mark.parametrize("impl", ["dot", "chunked"])
def test_generate_greedy_matches_reference(lengths, impl):
    """Equal prompts, and unequal ones (left-padded with token 0, unmasked,
    as the reference)."""
    rmodel, rparams, model, params = _pair(attn_impl=impl)
    prompts = _prompts(len(lengths), lengths)
    out = Server(model, params, batch_size=4, max_len=64).generate(prompts, max_new=8)
    ref = RServer(rmodel, rparams, batch_size=4, max_len=64).generate(prompts, max_new=8)
    assert out == ref and all(len(o) == 8 for o in out)


def test_generate_refuses_more_prompts_than_slots(tiny):
    _, _, model, params = tiny
    with pytest.raises(ValueError, match="slots"):
        Server(model, params, batch_size=1, max_len=64).generate(_prompts(0, (4, 4)))


# ---------------------------------------------------------------------------
# Server.serve: continuous batching
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slots,max_len,impl,chunk,lengths,top_len", [
    # tests/test_serving.py's case: 7 requests over 3 slots
    (3, 64, "dot", 1024, lambda i: 10, 19),
    (3, 64, "chunked", 1024, lambda i: 6 + i % 5, 17),
    # one slot: a single-sequence cache replaces the whole cache, while
    # ``len`` still merges by max (so it climbs request after request)
    (1, 64, "dot", 1024, lambda i: 10, 36),
    # past the cache: len reaches 19 of max_len 16
    (3, 16, "dot", 1024, lambda i: 10, 19),
    (3, 16, "chunked", 5, lambda i: 10, 19),
], ids=["3slots", "3slots-ragged-chunked", "1slot", "overflow-dot", "overflow-chunked5"])
def test_serve_matches_reference(slots, max_len, impl, chunk, lengths, top_len):
    """The result dict equals the reference's token for token: the shared
    ``len`` merged by max (its unmasked gap of zero keys and its jump of
    the RoPE positions), the greedy prefill token, every slot decoding
    every step. Overflow: writes clamp at the end of the cache. ``top_len``
    is the highest ``len`` a decode step starts from."""
    rmodel, rparams, model, params = _pair(attn_impl=impl, attn_chunk=chunk)
    reqs = _requests(Request, 2, 7, lengths, lambda i: 4 + i % 3)
    rreqs = _requests(RRequest, 2, 7, lengths, lambda i: 4 + i % 3)
    lens = []

    def decode_step(p, tok, state):
        lens.append(state["len"])
        return model.decode_step(p, tok, state)

    server = Server(dataclasses.replace(model, decode_step=decode_step), params,
                    batch_size=slots, max_len=max_len)
    res = server.serve(reqs)
    assert max(lens) == top_len
    ref = RServer(rmodel, rparams, batch_size=slots, max_len=max_len).serve(rreqs)
    assert res == ref
    assert sorted(res) == list(range(7))
    assert all(len(res[i]) == 4 + i % 3 for i in res)


def test_wanda_pruned_weights_serve_as_the_reference(tiny):
    """The port's Wanda prune of the carried weights served by the port,
    against the reference's prune served by the reference
    (tests/test_serving.py's case)."""
    rmodel, rparams, model, params = tiny
    calib = calibration_set(SyntheticCorpus(CorpusConfig(vocab_size=512)), 8, 32)
    rcalib = ref_calibration_set(RSyntheticCorpus(RCorpusConfig(vocab_size=512)), 8, 32)
    np.testing.assert_array_equal(calib, rcalib)
    _, pruned = prune(model, params, calib, method="wanda", sparsity=0.5)
    _, rpruned = ref_prune(rmodel, rparams, rcalib, method="wanda", sparsity=0.5)
    prompts = _prompts(3, (8, 8))
    out = Server(model, pruned, batch_size=2, max_len=32).generate(prompts, max_new=6)
    assert out == RServer(rmodel, rpruned, batch_size=2, max_len=32).generate(prompts, max_new=6)
    reqs = _requests(Request, 5, 4, lambda i: 8, lambda i: 3 + i)
    rreqs = _requests(RRequest, 5, 4, lambda i: 8, lambda i: 3 + i)
    assert Server(model, pruned, batch_size=2, max_len=32).serve(reqs) == \
        RServer(rmodel, rpruned, batch_size=2, max_len=32).serve(rreqs)


def test_temperature_sampling_repeats_under_a_seed(tiny):
    """temperature > 0: a categorical draw from a generator seeded by
    ``seed`` (not jax.random's): the same seed gives the same tokens."""
    _, _, model, params = tiny
    server = Server(model, params, batch_size=2, max_len=64, temperature=1.5)
    prompts = _prompts(6, (10, 7))
    a = server.generate(prompts, max_new=12, seed=3)
    assert a == server.generate(prompts, max_new=12, seed=3)
    assert a != server.generate(prompts, max_new=12, seed=4)
    assert all(0 <= t < 512 for o in a for t in o)
    served = [server.serve(_requests(Request, 8, 5, lambda i: 6, lambda i: 5), seed=s)
              for s in (1, 1)]
    assert served[0] == served[1]


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------
ARGV = ["--arch", "tiny_dense", "--requests", "5", "--slots", "2", "--device", "cpu"]


def test_serve_main_runs_and_writes_the_serve_artifact(tmp_path, capsys):
    bench = tmp_path / "BENCH_serve.json"
    res = SERVE.main(ARGV + ["--sparse", "0.5", "--bench-out", str(bench)])
    out = capsys.readouterr().out
    assert "serving wanda-pruned weights at sparsity 0.5" in out
    assert "served 5 requests, 80 tokens in" in out and "over 2 slots" in out
    assert sorted(res) == list(range(5)) and all(len(v) == 16 for v in res.values())
    payload = json.loads(bench.read_text())
    assert validate_payload(payload, require=["served"]) == []
    assert ref_validate(payload, require=["served"]) == []
    assert payload["served"]["requests"] == 5 and payload["served"]["tokens"] == 80
    man = payload["manifest"]
    assert man["name"] == "serve" and man["sparsity"] == 0.5
    assert man["batch_slots"] == 2 and man["requests"] == 5
    assert man["run_spec"]["kind"] == "serve" and man["run_spec"]["slots"] == 2
    assert set(SERVE_NAMES) <= set(payload["metrics"])
    assert payload["metrics"]["serve/tokens"]["value"] == 80
    assert payload["metrics"]["serve/requests"]["value"] == 5
    assert [n["name"] for n in payload["trace"]] == ["serve/batch"]


def test_serve_main_restores_a_reference_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` with a checkpoint that the reference's ``ckpt.save``
    wrote: the port serves the reference's weights, pruned by Wanda, to
    the same tokens as the reference's own launcher (their printed lines
    equal but for the seconds)."""
    rparams = ref_build(ref_get_config("tiny_dense")).init(jax.random.PRNGKey(1))
    RCK.save(str(tmp_path), {"params": rparams}, step=3)
    argv = ["--arch", "tiny_dense", "--requests", "5", "--slots", "2", "--sparse", "0.5",
            "--ckpt-dir", str(tmp_path), "--no-obs"]
    SERVE.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    RSERVE.main(argv)
    ref = capsys.readouterr().out.splitlines()
    assert out[0] == "loaded checkpoint step 3" == ref[0]
    assert [ln for ln in out if ln.startswith("  req ")] == \
        [ln for ln in ref if ln.startswith("  req ")]
    assert len([ln for ln in out if ln.startswith("  req ")]) == 3


def test_serve_main_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SERVE.main(["--arch", "tiny_dense", "--requests", "1", "--no-obs"])
