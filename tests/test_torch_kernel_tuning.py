"""The port's tile autotuner (``repro_torch.kernels.tuning``) on the CPU:
candidates, the plan builders behind them, the cache key and its
staleness fence, the modes and the persistent cache (corrupt entries and
files), the measured search (with its runner scripted, as the card is not
here), the launch shapes of an EBFT walk, and ``ebft_run --kernel-tune``
searching then hitting a warm cache, whose artifact both validators accept
(the cases of the reference's ``tests/test_kernel_tuning.py`` that do not
need its static-analysis passes)."""
from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_thread_module  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.launch import ebft_run as ref_ebft_run
from repro.launch.api import RunSpec as RefSpec
from repro.models.model import build as ref_build
from repro.obs.__main__ import main as ref_obs_cli
from repro.obs.run import validate_payload as ref_validate
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import ebft
from repro_torch.core.masks import prune
from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro_torch.kernels import tuning
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.launch import ebft_run
from repro_torch.models.model import build
from repro_torch.obs.run import validate_payload

BF, F32 = "bfloat16", "float32"
MM_BF = {"x": BF, "w": BF}
DIMS = {"M": 64, "K": 128, "N": 128}


@pytest.fixture(autouse=True)
def fresh_tuner(tmp_path):
    """Every test gets a clean tuner pointed at its own cache file."""
    tuning._reset_for_tests()
    tuning.configure(path=str(tmp_path / "cache.json"))
    yield
    tuning._reset_for_tests()


def _write_cache(entries, schema=tuning.SCHEMA) -> str:
    path = tuning.state()["path"]
    with open(path, "w") as f:
        json.dump({"schema": schema, "code_rev": tuning.code_rev(), "entries": entries}, f)
    return path


def _entry(tiles=None, dims=None, **over):
    base = {"kernel": "masked_matmul", "dims": dims or dict(DIMS), "dtypes": dict(MM_BF),
            "params": {}, "backend": "cpu", "device_kind": "cpu", "code_rev": tuning.code_rev(),
            "tiles": tiles if tiles is not None else {"bm": 128, "bn": 64, "bk": 64},
            "measured_s": None, "candidates": 1}
    base.update(over)
    return base


# ---------------------------------------------------------------------------
# candidates and plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,dims,dtypes,params,want", [
    ("masked_matmul", DIMS, MM_BF, {}, [(256, 128), (128, 128), (128, 64)]),
    ("masked_matmul_batched_dw", {"E": 4, **DIMS}, MM_BF, {}, [(256, 128), (128, 128),
                                                               (128, 64)]),
    ("nm_spmm", DIMS, {"x": BF, "v": BF}, {"n": 2, "m": 4}, [(256, 128), (128, 128), (128, 64)]),
    ("flash_attention", {"BH": 4, "Sq": 64, "Sk": 64, "d": 128}, {"q": BF}, {"causal": True},
     [(128, 128), (128, 64), (64, 128), (64, 64)]),
    ("flash_attention", {"BH": 4, "Sq": 64, "Sk": 64, "d": 16}, {"q": BF}, {}, [(128, 128)]),
    ("masked_matmul_dx", DIMS, {"x": F32, "w": F32}, {}, [(128, 128)]),
    ("flash_attention", {"BH": 4, "Sq": 64, "Sk": 64, "d": 64}, {"q": F32}, {}, [(64, 32)]),
])
def test_candidates_default_first_unique_and_valid(kernel, dims, dtypes, params, want):
    cands = tuning.candidate_tiles(kernel, dims, dtypes, params)
    default = tuning.build_plan(kernel, dims, dtypes, params, {})
    assert cands[0] == default.tiles
    keys = [tuple(t.values())[:2] for t in cands]
    assert keys == want and len(set(keys)) == len(keys)
    for tiles in cands:
        assert tuning.build_plan(kernel, dims, dtypes, params, tiles).tiles == tiles
    assert len(tuning.candidate_tiles(kernel, dims, dtypes, params, max_candidates=1)) == 1


def test_build_plan_rejects_unknown_kernels_and_knobs():
    with pytest.raises(ValueError, match="unknown kernel"):
        tuning.build_plan("conv", {}, {}, {}, {})
    with pytest.raises(ValueError, match="unknown tile knobs"):
        tuning.build_plan("masked_matmul", DIMS, MM_BF, {}, {"bz": 32})
    with pytest.raises(ValueError, match="unknown tile knobs"):
        tuning.build_plan("flash_attention", {"BH": 1, "Sq": 8, "Sk": 8, "d": 64}, {"q": BF},
                          {}, {"bm": 64})
    with pytest.raises(ValueError, match="is not compiled"):
        tuning.build_plan("masked_matmul", DIMS, MM_BF, {}, {"bm": 64, "bn": 64})


# ---------------------------------------------------------------------------
# the cache key and its staleness fence
# ---------------------------------------------------------------------------
def test_cache_key_ignores_insertion_order():
    a = tuning.cache_key("mm", {"M": 1, "K": 2}, {"x": F32}, {"p": 3}, "cuda", "H100", "rev")
    b = tuning.cache_key("mm", {"K": 2, "M": 1}, {"x": F32}, {"p": 3}, "cuda", "H100", "rev")
    assert a == b
    assert a != tuning.cache_key("mm", {"M": 1, "K": 2}, {"x": F32}, {"p": 3}, "cuda", "H100",
                                 "other-rev")
    assert a != tuning.cache_key("mm", {"M": 1, "K": 2}, {"x": F32}, {"p": 3}, "cpu", "cpu",
                                 "rev")


def test_code_rev_changes_with_a_kernel_source(tmp_path):
    """On a copied tree: an edited ``.cu`` (or ``.cuh``) changes the hash,
    a file that is not a source does not."""
    assert tuning.code_rev() == tuning.code_rev() and len(tuning.code_rev()) == 12
    trees = {}
    for name in ("same", "cu", "cuh", "other"):
        trees[name] = tmp_path / name
        shutil.copytree(tuning.PACKAGE, trees[name],
                        ignore=shutil.ignore_patterns("__pycache__"))
    (trees["cu"] / "csrc" / "masked_matmul.cu").write_text(
        (trees["cu"] / "csrc" / "masked_matmul.cu").read_text() + "\n// edited\n")
    (trees["cuh"] / "csrc" / "gemm.cuh").write_text("// another main loop\n")
    (trees["other"] / "notes.txt").write_text("not a source")
    revs = {name: tuning.code_rev(root) for name, root in trees.items()}
    assert revs["same"] == revs["other"] == tuning.code_rev()
    assert len({revs["same"], revs["cu"], revs["cuh"]}) == 3


# ---------------------------------------------------------------------------
# modes and the persistent cache
# ---------------------------------------------------------------------------
def test_mode_off_resolves_nothing_and_counts_nothing():
    assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu") == ({}, None)
    assert tuning.stats() == {"hits": 0, "misses": 0, "searches": 0, "search_s": 0.0}
    with pytest.raises(ValueError, match="not one of"):
        tuning.configure(mode="always")


def test_a_cache_miss_counts_and_writes_nothing():
    tuning.configure(mode="cache")
    assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu") == ({}, "default")
    assert tuning.stats()["misses"] == 1 and tuning.stats()["hits"] == 0
    assert not os.path.exists(tuning.state()["path"])


def test_search_then_store_then_a_fresh_load_hits():
    entry = tuning.search("masked_matmul_dw", DIMS, MM_BF, device="cpu")
    # on the CPU the plain versions take no tiles: the default, unmeasured
    assert entry["tiles"] == {"bm": 256, "bn": 128, "bk": 64}
    assert entry["measured_s"] is None and entry["candidates"] == 1
    path = tuning.state()["path"]
    key = tuning.store(entry)
    tuning._reset_for_tests("cache")
    tuning.configure(path=path)
    assert tuning.resolve("masked_matmul_dw", DIMS, MM_BF, device="cpu") == (entry["tiles"],
                                                                               "cache")
    assert tuning.stats()["hits"] == 1 and tuning.state()["entries"] == 1
    assert key.startswith("masked_matmul_dw|K=128,M=64,N=128|")


def test_search_mode_persists_and_a_later_process_hits():
    tuning.configure(mode="search")
    tiles, source = tuning.resolve("flash_attention", {"BH": 2, "Sq": 16, "Sk": 16, "d": 64},
                                   {"q": BF}, {"causal": True}, device="cpu")
    assert (tiles, source) == ({"bq": 128, "bk": 128}, "search")
    assert tuning.stats()["searches"] == 1 and tuning.stats()["search_s"] > 0
    payload = json.load(open(tuning.state()["path"]))
    assert payload["schema"] == tuning.SCHEMA and len(payload["entries"]) == 1
    path = tuning.state()["path"]
    tuning._reset_for_tests("cache")
    tuning.configure(path=path)
    assert tuning.resolve("flash_attention", {"BH": 2, "Sq": 16, "Sk": 16, "d": 64}, {"q": BF},
                          {"causal": True}, device="cpu")[1] == "cache"


@pytest.mark.parametrize("tiles", [{"bm": 96, "bn": 128}, {"bm": "x"}, {"bq": 64}, None])
def test_corrupt_cached_tiles_degrade_to_a_miss(tiles):
    entry = _entry(tiles={} if tiles is None else tiles)
    if tiles is None:
        entry.pop("tiles")
    key = tuning.cache_key("masked_matmul", DIMS, MM_BF, {}, "cpu", "cpu", tuning.code_rev())
    _write_cache({key: entry})
    tuning.configure(mode="cache")
    assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu") == ({}, "default")
    assert tuning.stats()["misses"] == 1


def test_a_cached_launch_is_checked_once(monkeypatch):
    """The first resolve of a launch shape builds its entry's plan; later
    launches of it read the result and still count as hits."""
    key = tuning.cache_key("masked_matmul", DIMS, MM_BF, {}, "cpu", "cpu", tuning.code_rev())
    _write_cache({key: _entry()})
    tuning.configure(mode="cache")
    built = []
    build_plan = tuning.build_plan
    monkeypatch.setattr(tuning, "build_plan", lambda *a: built.append(a) or build_plan(*a))
    for _ in range(3):
        assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu") == (
            {"bm": 128, "bn": 64, "bk": 64}, "cache")
    assert len(built) == 1 and tuning.stats()["hits"] == 3


def test_a_causal_launch_past_offset_0_runs_the_default():
    """The attention key leaves q_offset out and the search times offset 0,
    so a causal launch at an offset (a decode step) resolves nothing; at
    offset 0, or not causal, it reads the cache."""
    from repro_torch.kernels.flash_attention import ops as FA

    dims = {"BH": 2, "Sq": 16, "Sk": 16, "d": 64}
    tuning.configure(mode="search")
    q = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    for causal in (True, False):
        tuning.resolve("flash_attention", dims, {"q": BF}, {"causal": causal}, device="cpu")
    tuning.reset_stats()
    assert FA._resolve(q, q, True, 0, {}) == ({"bq": 128, "bk": 128}, "cache")
    assert FA._resolve(q, q, False, 5, {}) == ({"bq": 128, "bk": 128}, "cache")
    assert FA._resolve(q, q, True, 5, {}) == ({}, None)
    assert FA._resolve(q, q, True, 5, {"bq": 64}) == ({"bq": 64}, None)
    assert tuning.stats()["hits"] == 2 and tuning.stats()["misses"] == 0


@pytest.mark.parametrize("content", ["{not json", "[1, 2]", json.dumps({"schema": "x/v0"}),
                                     json.dumps({"schema": "repro.kernels.tuning/v1",
                                                 "entries": {}})])
def test_a_garbage_or_foreign_file_starts_fresh(content):
    with open(tuning.state()["path"], "w") as f:
        f.write(content)
    tuning.configure(mode="cache")
    assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu") == ({}, "default")
    assert tuning.state()["entries"] == 0


def test_a_stale_code_rev_misses():
    key = tuning.cache_key("masked_matmul", DIMS, MM_BF, {}, "cpu", "cpu", "0123456789ab")
    _write_cache({key: _entry(code_rev="0123456789ab")})
    tuning.configure(mode="cache")
    assert tuning.resolve("masked_matmul", DIMS, MM_BF, device="cpu")[1] == "default"


# ---------------------------------------------------------------------------
# the measured search, its runner scripted
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("times,best", [
    ({(256, 128): 3.0, (128, 128): 1.0, (128, 64): 2.0}, (128, 128)),
    ({(256, 128): 1.0, (128, 128): 1.0, (128, 64): 2.0}, (256, 128)),  # a tie keeps the default
])
def test_the_search_measures_the_default_inside_its_sweep(monkeypatch, times, best):
    order = []

    def make_runner(kernel, dims, dtypes, params, device):
        assert (kernel, device.type) == ("masked_matmul_batched", "cuda")
        return lambda tiles: order.append((tiles["bm"], tiles["bn"])) or order[-1]

    monkeypatch.setattr(tuning, "_make_runner", make_runner)
    monkeypatch.setattr(tuning, "_timed", lambda run, reps: times[run()])
    monkeypatch.setattr(tuning, "_device_kind", lambda device: "NVIDIA H100 80GB HBM3")
    dims = {"E": 8, **DIMS}
    entry = tuning.search("masked_matmul_batched", dims, MM_BF, device="cuda", reps=1)
    assert order == list(times)  # the default first, in the same sweep
    assert (entry["tiles"]["bm"], entry["tiles"]["bn"]) == best
    ms = entry["measured_s"]
    assert ms["default"] == times[(256, 128)] and ms["best"] == min(times.values())
    assert ms["best"] <= ms["default"] and entry["candidates"] == 3
    assert (entry["backend"], entry["device_kind"]) == ("cuda", "NVIDIA H100 80GB HBM3")
    tuning.build_plan(entry["kernel"], entry["dims"], entry["dtypes"], entry["params"],
                      entry["tiles"])  # the winner launches


# ---------------------------------------------------------------------------
# the launches of an EBFT walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tiny_dense", "tiny_moe"])
def test_ebft_workloads_cover_the_walks_launches(arch, monkeypatch):
    """Every 2-D and expert-batched masked product an EBFT walk launches
    (recorded at the wrappers) is among ``ebft_workloads``' shapes."""
    cfg = get_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    seq = 32
    calib = calibration_set(SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0)),
                            8, seq)
    masks, pruned = prune(model, params, calib, method="wanda", sparsity=0.5)
    seen = set()
    recorded = MM._recorded

    def record(name, fn, a, b, c, M, K, N, out_shape, E=1, plan=None):
        dims = {"M": M, "K": K, "N": N, **({"E": E} if "batched" in name else {})}
        seen.add((name.removeprefix("kernels/"), tuple(sorted(dims.items())), str(a.dtype)))
        return recorded(name, fn, a, b, c, M, K, N, out_shape, E, plan)

    monkeypatch.setattr(MM, "_recorded", record)
    ebft.finetune(model, params, pruned, masks, calib, ebft.EBFTConfig(lr=1e-3, epochs=1))
    work = {(k, tuple(sorted(d.items())), "torch." + t["x"])
            for k, d, t, _ in tuning.ebft_workloads(cfg, tokens=8 * seq, seq=seq)
            if k.startswith("masked_matmul")}
    assert seen and seen <= work, seen - work
    routes = {k for k, _, _ in seen}
    assert {"masked_matmul", "masked_matmul_dw"} <= routes
    if arch == "tiny_moe":
        assert {"masked_matmul_batched", "masked_matmul_batched_dw"} <= routes
    attn = [d for k, d, _, p in tuning.ebft_workloads(cfg, 8 * seq, seq) if k == "flash_attention"]
    assert attn == [{"BH": 8 * cfg.num_heads, "Sq": seq, "Sk": seq, "d": cfg.resolved_head_dim}]


def test_ebft_workloads_of_the_card_paths():
    """Llama-7B's walk at 8 x 2048 rows: four weight shapes, three routes
    each, and the attention; Seamless-M4T-medium's encoder and memory run
    at 8 x 256 rows, its attention three ways; N:M where the pattern
    divides K."""
    llama = tuning.ebft_workloads(get_config("llama_7b"), 8 * 2048, 2048, pattern=(2, 4))
    kinds = [k for k, *_ in llama]
    assert kinds.count("masked_matmul") == kinds.count("masked_matmul_dw") == 3
    assert kinds.count("nm_spmm") == 3 and kinds.count("flash_attention") == 1
    assert {d["K"] for k, d, *_ in llama if k == "masked_matmul"} == {4096, 11008}
    seamless = tuning.ebft_workloads(get_config("seamless_m4t_medium"), 8 * 2048, 2048)
    ms = {(d["M"], d["K"], d["N"]) for k, d, *_ in seamless if k == "masked_matmul"}
    assert (2048, 1024, 1024) in ms and (16384, 1024, 4096) in ms
    assert [(d["Sq"], d["Sk"], p["causal"]) for k, d, _, p in seamless
            if k == "flash_attention"] == [(2048, 2048, True), (256, 256, False),
                                           (2048, 256, False)]
    assert all(t == {"x": "float32", "w": "float32"} for k, d, t, _ in llama[:3])
    moe = tuning.ebft_workloads(get_config("deepseek_moe_16b"), 8 * 2048, 2048)
    assert ("masked_matmul_batched", {"E": 64, "M": 1920, "K": 2048, "N": 1408},
            {"x": "float32", "w": "float32"}, {}) in moe


# ---------------------------------------------------------------------------
# ebft_run --kernel-tune
# ---------------------------------------------------------------------------
def test_spec_defaults_mirror_reference():
    assert ebft_run.RunSpec().kernel_tune == RefSpec().kernel_tune == "cache"
    assert ebft_run.RunSpec().kernel_cache == RefSpec().kernel_cache == ""
    with pytest.raises(SystemExit):
        ebft_run.main(["--kernel-tune", "always", "--device", "cpu"])


def test_ebft_run_searches_then_hits_a_warm_cache(tmp_path, capsys):
    """``--kernel-tune search`` then ``cache`` on one cache: the second
    artifact's ``kernel_tuning`` is warm for the port's and the reference's
    validators, and every perplexity equals an ``off`` run's bit for bit and
    the reference driver's within rel 1e-4."""
    cache = tmp_path / "kernels.json"
    argv = ["--arch", "tiny_dense", "--pretrain-steps", "0", "--epochs", "1",
            "--calib-samples", "8", "--seq", "32"]
    out = {}
    for mode in ("search", "cache", "off"):
        bench = tmp_path / f"{mode}.json"
        res = ebft_run.main(argv + ["--device", "cpu", "--kernel-tune", mode,
                                    "--kernel-cache", str(cache), "--bench-out", str(bench)])
        out[mode] = (res, json.loads(bench.read_text()))
    console = capsys.readouterr().out
    assert "kernel plans: 10 workloads, 0 cached, 10 searched" in console
    assert "kernel plans: 10 workloads, 10 cached, 0 searched" in console
    search, cache_run, off = (out[m][1] for m in ("search", "cache", "off"))
    assert search["kernel_tuning"]["searches"] == search["kernel_tuning"]["misses"] == 10
    assert cache_run["kernel_tuning"] == {"mode": "cache", "cache_path": str(cache), "hits": 10,
                                          "misses": 0, "searches": 0, "search_s": 0.0}
    assert off["kernel_tuning"]["mode"] == "off" and off["kernel_tuning"]["hits"] == 0
    assert list(cache_run["phases"])[0] == "kernel_tune" and "kernel_tune" not in off["phases"]
    require = ["phases", "kernel_tuning"]
    assert validate_payload(cache_run, require=require, require_cache_hits=True) == []
    assert ref_validate(cache_run, require=require, require_cache_hits=True) == []
    assert validate_payload(search, require_cache_hits=True)  # cold: refused
    assert ref_obs_cli(["validate", str(tmp_path / "cache.json"), "--require-cache-hits"]) == 0
    assert search["perplexity"] == cache_run["perplexity"] == off["perplexity"]
    assert len(json.load(open(cache))["entries"]) == 10
    # the reference driver on the same argv, its tuner off, against the
    # port's run from the reference's init on the warm cache
    ref_out = tmp_path / "ref.json"
    ref_ebft_run.main(argv + ["--kernel-tune", "off", "--bench-out", str(ref_out)])
    ref = json.loads(ref_out.read_text())
    spec = ebft_run.RunSpec(pretrain_steps=0, epochs=1, calib_samples=8, seq=32,
                            kernel_tune="cache", kernel_cache=str(cache))
    ref_params = ref_build(ref_get_config("tiny_dense")).init(jax.random.PRNGKey(spec.seed))
    res = ebft_run.run(get_config("tiny_dense"), spec, "cpu",
                       params=interop.params_to_torch(jax.tree.map(np.asarray, ref_params), "cpu"))
    assert (res.kernel_tuning["hits"], res.kernel_tuning["misses"]) == (10, 0)
    for k, v in ref["perplexity"].items():
        assert res.perplexity[k] == pytest.approx(v, rel=1e-4), k
