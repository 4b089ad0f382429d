"""The port's static checks (``repro_torch.analysis``).

Held to the reference's ``repro.analysis`` on the same inputs where its
tests are green: the report's text and JSON, the CFG findings of every
config and fixture, OBS001–003 on one seeded source tree in the
reference's spellings, MSK002–004 on the same numpy mask trees. Held by
the port's own positive and negative cases where the reference's are red
or have no counterpart: MSK001 over aten graphs, LNT001–003, KER001–005,
TUN001–004, the CLI. The MoE aux loss's counts (a scatter-add, no host
read) are held to ``torch.bincount``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_analysis_fixtures import BAD_HEAD_WIDTH, BAD_HEADS, BAD_TILES
from repro_torch.analysis import PASS_NAMES, Finding, Report, run
from repro_torch.analysis import passes as P
from repro_torch.analysis.config_check import check_model_config
from repro_torch.analysis.graph_lint import lint_graph
from repro_torch.analysis.graph_utils import call_nodes, op_name, trace
from repro_torch.analysis.kernel_check import check_config_kernels, plan_findings, planned
from repro_torch.analysis.mask_check import check_mask_tree, check_masked_fn
from repro_torch.analysis.source_lint import check_sources
from repro_torch.analysis.tuning_cache import check_cache
from repro_torch.configs import CONFIG_IDS, get_config
from repro_torch.core import reconstruction as R
from repro_torch.kernels import tuning
from repro_torch.kernels import validation as V
from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.models import moe
from repro_torch.sparsity import sparse_params as SP

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = {"bad_tiles": BAD_TILES, "bad_heads": BAD_HEADS, "bad_head_width": BAD_HEAD_WIDTH}


def codes(findings):
    return {f.code for f in findings}


def errors(findings):
    return [f for f in findings if f.severity == "error"]


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_report(tmp_path_factory):
    """All six passes over every shipped config, once (no tuning cache)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cache = tmp_path_factory.mktemp("cache") / "none.json"
        return run(tuning_cache_path=str(cache))
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# findings / report, held to the reference
# ---------------------------------------------------------------------------
_FINDINGS = [("KER001", "error", "kernels", "tile", "llama_7b", "masked_matmul/w_up"),
             ("OBS003", "warn", "source_lint", "host read", "", "core/x.py:3"),
             ("KER004", "info", "kernels", "ring", "tiny_dense", ""),
             ("CFG002", "error", "sharding", "heads", "bad_heads", "config")]


@pytest.mark.parametrize("ignored", [[], ["KER001"], ["KER001", "CFG002", "OBS003"]])
def test_report_text_and_json_equal_the_reference(ignored):
    from repro.analysis import findings as RF

    mine = Report(findings=[Finding(*f) for f in _FINDINGS], passes_run=["kernels", "masks"],
                  configs_checked=["llama_7b", "tiny_dense"]).without(ignored)
    ref = RF.Report(findings=[RF.Finding(*f) for f in _FINDINGS],
                    passes_run=["kernels", "masks"],
                    configs_checked=["llama_7b", "tiny_dense"]).without(ignored)
    assert mine.to_text() == ref.to_text()
    assert mine.to_json() == ref.to_json()
    for fail_on in ("error", "warn", "info", "never"):
        assert mine.exit_code(fail_on) == ref.exit_code(fail_on)
    assert mine.max_severity() == ref.max_severity()


def test_finding_rejects_bad_severity():
    with pytest.raises(ValueError):
        Finding("X", "fatal", "kernels", "msg")


# ---------------------------------------------------------------------------
# CFG, held to the reference on every config and fixture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIG_IDS + list(FIXTURES))
def test_config_findings_equal_the_reference(name):
    from repro.analysis.config_check import check_model_config as ref_check
    from repro.configs import get_config as ref_get
    from repro.configs.base import ModelConfig as RefConfig

    cfg = FIXTURES[name] if name in FIXTURES else get_config(name)
    ref_cfg = RefConfig(**dataclasses.asdict(cfg)) if name in FIXTURES else ref_get(name)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)

    def key(fs):
        return sorted((f.code, f.severity, f.location, f.message) for f in fs)

    mine = check_model_config(name, cfg)
    assert key(mine) == key(ref_check(name, ref_cfg))
    assert bool(mine) == (name == "bad_heads")


def test_config_check_flags_indivisible_d_model():
    cfg = BAD_HEADS.replace(name="bad_dm", num_heads=3, num_kv_heads=3, head_dim=0)
    assert "CFG001" in codes(check_model_config("bad_dm", cfg))


# ---------------------------------------------------------------------------
# source_lint: OBS001–003 held to the reference on one seeded tree
# ---------------------------------------------------------------------------
_SEEDED_TREE = {
    "core/hot.py": (
        "import time\n"
        "import numpy as np\n"
        "t0 = time.time()\n"                      # OBS002
        "print('debug')\n"                        # OBS001 (hot path)
        "# print('in a comment is fine')\n"
        "pprint(x)\n"                             # not print()
        "obj.print()\n"                           # method call, not builtin
        "x = float(y)\n"                          # out of loop: fine
        "for i in range(3):\n"
        "    a = float(z[i])\n"                   # OBS003
        "    b = np.asarray(z[i])\n"              # OBS003
        "    c = jnp.asarray(z[i])\n"             # jnp staging: fine
        "    d = float(w)  # obs: sync-ok why\n"  # suppressed inline
        "    # obs: sync-ok (epoch mean)\n"
        "    e = float(v)\n"                      # suppressed by the line above
        "while cond:\n"
        "    f = float(q)\n"                      # OBS003
        "g = float(done)\n"                       # loop exited: fine
    ),
    "core/nest.py": (
        "for i in range(3):\n"
        "    for j in range(3):\n"
        "        a = float(x[i][j])\n"            # OBS003 (inner)
        "    b = float(y[i])\n"                   # OBS003 (outer loop still open)
        "c = float(z)\n"
    ),
    "launch/cli.py": (
        "print('drivers may print')\n"
        "import time; t = time.time()\n"          # OBS002 applies everywhere
        "for i in range(3):\n"
        "    x = float(y[i])\n"                   # not a hot-path package
    ),
    "obs/impl.py": "import time\nnow = time.time()\n",  # never scanned
    "analysis/self.py": "print('x')\nimport time; time.time()\n",
    "core/ok.py": "import time\nt = time.perf_counter()\n",
}


def _write_tree(root: Path, files) -> None:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)


def test_source_lint_equals_the_reference_on_a_seeded_tree(tmp_path):
    from repro.analysis.source_lint import check_sources as ref_check

    _write_tree(tmp_path, _SEEDED_TREE)

    def key(fs, pkg):
        out = []
        for f in fs:
            assert f.location.startswith(pkg + "/"), f.location
            out.append((f.code, f.severity, f.location[len(pkg) + 1:]))
        return sorted(out)

    mine = key(check_sources(src_root=str(tmp_path)), "repro_torch")
    assert mine == key(ref_check(src_root=str(tmp_path)), "repro")
    assert [c for c, _, _ in mine].count("OBS003") == 5
    assert {c for c, _, _ in mine} == {"OBS001", "OBS002", "OBS003"}


def test_source_lint_flags_torch_host_reads(tmp_path):
    _write_tree(tmp_path, {"serving/loop.py": (
        "for step in range(4):\n"
        "    a = t.item()\n"                      # OBS003
        "    b = t.tolist()\n"                    # OBS003
        "    c = t.cpu()\n"                       # OBS003
        "    for k, v in d.items():\n"            # .items() is not .item()
        "        e = t.cpu  # obs: sync-ok\n"
        "    # obs: sync-ok (the host hands the token back)\n"
        "    f = t.tolist()\n"
        "g = t.item()\n"                          # after the loop: fine
    )})
    found = check_sources(src_root=str(tmp_path))
    assert sorted(f.location for f in found) == [
        f"repro_torch/serving/loop.py:{n}" for n in (2, 3, 4)]
    assert codes(found) == {"OBS003"} and not errors(found)


def test_source_lint_clean_on_the_real_tree():
    assert check_sources() == []


# ---------------------------------------------------------------------------
# masks: MSK002–004 held to the reference on the same numpy trees
# ---------------------------------------------------------------------------
def _np_nm_mask(w: np.ndarray, lead: int, n: int = 2, m: int = 4) -> np.ndarray:
    """A 2:4 mask of |w| along the reduction axis of w's (R, O) view."""
    shape = w.shape
    mat = np.abs(w).reshape(int(np.prod(shape[:lead])), -1)
    R, O = mat.shape
    order = np.argsort(-mat.reshape(R // m, m, O), axis=1, kind="stable")
    keep = np.zeros((R // m, m, O), bool)
    np.put_along_axis(keep, order[:, :n], True, axis=1)
    return keep.reshape(shape).astype(np.float32)


def _mask_trees(case: str):
    rng = np.random.default_rng(0)
    params = {"attn": {"wq": rng.normal(size=(16, 2, 4)).astype(np.float32),
                       "wo": rng.normal(size=(2, 4, 16)).astype(np.float32)},
              "mlp": {"w_up": rng.normal(size=(16, 8)).astype(np.float32)},
              "ln1": {"w": np.ones(16, np.float32)}}
    masks = {"attn": {"wq": _np_nm_mask(params["attn"]["wq"], 1),
                      "wo": _np_nm_mask(params["attn"]["wo"], 2)},
             "mlp": {"w_up": _np_nm_mask(params["mlp"]["w_up"], 1)},
             "ln1": {"w": np.ones((), np.float32)}}
    nm = (2, 4)
    if case == "tampered":
        masks["mlp"]["w_up"][0, 0] = 1.0 - masks["mlp"]["w_up"][0, 0]
    elif case == "soft":
        masks["attn"]["wq"] = np.full((16, 2, 4), 0.5, np.float32)
    elif case == "indivisible":
        params["mlp"]["w_down"] = rng.normal(size=(6, 16)).astype(np.float32)
        masks["mlp"]["w_down"] = np.ones((6, 16), np.float32)
    elif case == "dense":
        masks = {k: {kk: np.ones_like(v) for kk, v in d.items()} for k, d in masks.items()}
        nm = None
    return params, masks, nm


@pytest.mark.parametrize("case,want", [("good", set()), ("tampered", {"MSK003"}),
                                       ("soft", {"MSK002"}), ("indivisible", {"MSK004"}),
                                       ("dense", set())])
def test_mask_tree_findings_equal_the_reference(case, want):
    from repro.analysis.mask_check import check_mask_tree as ref_check

    params, masks, nm = _mask_trees(case)

    def key(fs):
        return sorted((f.code, f.severity, f.location, f.message) for f in fs)

    mine = check_mask_tree(masks, params, nm=nm, config="t")
    assert key(mine) == key(ref_check(masks, params, nm=nm, config="t"))
    assert codes(mine) == want


# ---------------------------------------------------------------------------
# masks: MSK001 over aten graphs (the port's own cases)
# ---------------------------------------------------------------------------
def _w_and_masks():
    g = torch.Generator().manual_seed(0)
    w = {"w_up": torch.randn(16, 8, generator=g)}
    return w, SP.ones_masks(w), torch.randn(4, 16, generator=g)


def test_mask_check_flags_unmasked_product():
    w, masks, x = _w_and_masks()
    found = check_masked_fn(lambda w_, m_, x_: (x_ @ w_["w_up"]).sum(), w, masks, x)
    assert codes(found) == {"MSK001"} and errors(found)


@pytest.mark.parametrize("how", ["mul", "masked_matmul"])
def test_mask_check_accepts_masked_product(how):
    w, masks, x = _w_and_masks()
    if how == "mul":
        def fn(w_, m_, x_):
            return (x_ @ (w_["w_up"] * m_["w_up"])).sum()
    else:
        def fn(w_, m_, x_):
            return masked_matmul(x_, w_["w_up"], m_["w_up"]).sum()
    assert check_masked_fn(fn, w, masks, x) == []


def test_mask_check_follows_a_python_loop():
    """The taint follows a weight carried through an unrolled loop."""
    w, masks, x = _w_and_masks()

    def fn(w_, m_, x_):
        h = x_
        for _ in range(3):
            h = h @ (w_["w_up"] * m_["w_up"]) @ w_["w_up"].T  # the second use is unmasked
        return h.sum()

    assert codes(check_masked_fn(fn, w, masks, x)) == {"MSK001"}


_BLOCKS = [("tiny_dense", 0), ("tiny_moe", 0), ("tiny_moe", 1), ("tiny_ssm", 0),
           ("tiny_hybrid", 0), ("tiny_hybrid", -1), ("tiny_vlm", 0), ("tiny_encdec", 0),
           ("tiny_encdec", 2)]


def _block(arch: str, i: int):
    smoke = get_config(arch, smoke=True)
    model, params = P._smoke_model(smoke)
    i = model.num_blocks - 1 if i < 0 else i
    bw = model.get_block(params, i)
    h, pos, aux = P._block_io(model, i)
    return model, i, bw, h, pos, aux


@pytest.mark.parametrize("arch,i", _BLOCKS)
def test_mask_check_real_block_loss_is_masked(arch, i, one_thread):
    """Every family's block_loss masks each prunable leaf before its
    product; the same loss with the masks left out is flagged."""
    model, i, bw, h, pos, aux = _block(arch, i)

    def loss(bw_, masks_, h_, pos_):
        return R.block_loss(model, i, bw_, masks_, h_, h_, pos_, aux)

    assert check_masked_fn(loss, bw, SP.ones_masks(bw), h, pos) == []

    def unmasked(bw_, masks_, h_, pos_):
        return R.block_loss(model, i, bw_, None, h_, h_, pos_, aux)

    assert codes(check_masked_fn(unmasked, bw, SP.ones_masks(bw), h, pos)) == {"MSK001"}


# ---------------------------------------------------------------------------
# graph lint: LNT001–003
# ---------------------------------------------------------------------------
_bf = torch.bfloat16


@pytest.mark.parametrize("read", ["float", "item", "bincount", "nonzero"])
def test_lint_flags_host_reads(read):
    fns = {"float": lambda x: x * float(x.sum()), "item": lambda x: x + x.max().item(),
           "bincount": lambda x: torch.bincount(x.long().abs(), minlength=4).float(),
           "nonzero": lambda x: torch.nonzero(x).float().sum()}
    found = lint_graph(trace(fns[read], torch.arange(4.0)), where="t")
    assert codes(found) == {"LNT002"} and errors(found)


def test_lint_flags_silent_widening():
    found = lint_graph(trace(lambda x: x.float() + 1.0, torch.ones(4, dtype=_bf)), where="t")
    assert codes(found) == {"LNT001"} and not errors(found)


def test_lint_allows_accumulator_widening():
    gm = trace(lambda x, w: x.float() @ w.float(), torch.ones(4, 4, dtype=_bf),
               torch.ones(4, 4, dtype=_bf))
    gm2 = trace(lambda x: x.float().sum(), torch.ones(4, dtype=_bf))
    assert lint_graph(gm, where="t") == [] and lint_graph(gm2, where="t") == []


def test_lint_flags_convert_round_trip():
    gm = trace(lambda x: x.to(_bf).to(torch.float32) * 2.0, torch.ones(4))
    found = lint_graph(gm, where="t")  # the second cast also widens into a mul
    assert codes(found) == {"LNT001", "LNT003"} and not errors(found)
    assert [f.severity for f in found if f.code == "LNT003"] == ["info"]


def test_lint_clean_function_is_clean():
    assert lint_graph(trace(lambda x, w: torch.tanh(x @ w), torch.ones(4, 4),
                            torch.ones(4, 4)), where="t") == []


# ---------------------------------------------------------------------------
# the MoE aux loss: counts without a host read
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_counts_equal_bincount(seed):
    rng = np.random.default_rng(seed)
    E = 8
    idx = torch.from_numpy(rng.integers(0, E - 2, size=(37, 3)))  # some experts get none
    want = torch.bincount(idx.reshape(-1), minlength=E).float()
    got = moe.expert_counts(idx, E)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_moe_aux_loss_bits_unchanged():
    cfg = get_config("tiny_moe")
    model, params = P._smoke_model(get_config("tiny_moe", smoke=True))
    p = model.get_block(params, cfg.moe_first_dense)["moe"]
    xf = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(3))
    _, aux = moe._dispatch_group(p, xf, cfg)
    _, idx, probs = moe.route(p["router"]["w"], xf, cfg.moe_top_k)
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (64 * k)
    assert torch.equal(aux, E * torch.sum(probs.mean(dim=0) * ce))


def test_moe_block_and_decode_trace_without_host_reads(one_thread):
    smoke = get_config("tiny_moe", smoke=True)
    i = smoke.moe_first_dense
    model, i, bw, h, pos, aux = _block("tiny_moe", i)
    gm = trace(lambda bw_, m_, h_, p_: R.block_loss(model, i, bw_, m_, h_, h_, p_),
               bw, SP.ones_masks(bw), h, pos)
    for graph in (gm, P.tune_step_graph(smoke, i)[0], P.decode_step_graph(smoke)):
        names = [op_name(n) for n in call_nodes(graph)]
        assert "_local_scalar_dense" not in names and "bincount" not in names
        assert "LNT002" not in codes(lint_graph(graph, where="t"))


# ---------------------------------------------------------------------------
# kernels: KER001–005
# ---------------------------------------------------------------------------
def test_kernel_pass_flags_untileable_config():
    found = check_config_kernels("bad_tiles", BAD_TILES)
    ker1 = [f for f in found if f.code == "KER001"]
    assert ker1 and all("bfloat16" in f.location for f in ker1)
    assert any("w_up" in f.location for f in ker1) and any("w_down" in f.location for f in ker1)
    assert any(f.code == "KER005" and "w_down" in f.location and f.severity == "warn"
               for f in found)


def test_kernel_pass_flags_uncompiled_head_width():
    found = check_config_kernels("bad_head_width", BAD_HEAD_WIDTH)
    ker1 = [f for f in found if f.code == "KER001"]
    assert ker1 and all(f.location.startswith("flash_attention") for f in ker1)
    assert {("bfloat16" in f.location) for f in ker1} == {True, False}  # both dtypes


def test_kernel_pass_in_dt_needs_the_aligned_mask():
    """Mamba2-130M's in_dt (768 x 24): clean with aligned_mask's layout,
    KER001 with a contiguous mask (rows 24 bytes apart); its bf16 nm_spmm
    is unavailable either way (KER005)."""
    cfg = get_config("mamba2_130m")
    aligned = check_config_kernels("mamba2_130m", cfg)
    assert not errors(aligned)
    assert [f.location for f in aligned if f.code == "KER005"] == [
        "nm_spmm/in_dt (8192x768x24, bfloat16)"]
    contiguous = errors(check_config_kernels("mamba2_130m", cfg, aligned_masks=False))
    assert contiguous and all(f.code == "KER001" and "/in_dt " in f.location
                              and "bfloat16" in f.location for f in contiguous)
    assert {f.location.split("/")[0] for f in contiguous} == {
        "masked_matmul", "masked_matmul_dx", "masked_matmul_dw"}


def _plan(**kw):
    base = V.plan_masked_matmul("masked_matmul", 1024, 1024, 1024)
    return dataclasses.replace(base, **kw)


def test_kernel_plan_checks_on_forged_plans():
    good = _plan()
    assert good.stages == V.GEMM_MAX_STAGES and plan_findings(good, "c", "l") == []
    assert codes(plan_findings(_plan(smem=V.SMEM_MAX + 1), "c", "l")) == {"KER002"}
    bad_map = dataclasses.replace(good.maps[0], strides=(24, 48))
    assert codes(plan_findings(_plan(maps=(bad_map,)), "c", "l")) == {"KER003"}
    assert codes(plan_findings(_plan(grid=(1, V.MAX_GRID_YZ + 1, 1)), "c", "l")) == {"KER003"}
    shallow = plan_findings(_plan(stages=2), "c", "l")
    assert codes(shallow) == {"KER004"} and not errors(shallow)
    attn = V.plan_flash_attention(8, 1024, 1024, 128)
    assert plan_findings(attn, "c", "l") == []
    assert codes(plan_findings(dataclasses.replace(attn, stages=attn.stages - 1), "c",
                               "l")) == {"KER004"}
    f32 = V.plan_masked_matmul("masked_matmul", 1024, 1024, 1024, dtype="float32")
    assert f32.stages == 0 and plan_findings(f32, "c", "l") == []


def test_kernel_pass_plans_every_route():
    plans, found = planned("seamless_m4t_medium", get_config("seamless_m4t_medium"))
    assert found == []
    routes = {(p.route, p.dtype) for _, p in plans}
    for dt in ("bfloat16", "float32"):
        for r in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "nm_spmm",
                  "flash_attention", "flash_attention_bwd"):
            assert (r, dt) in routes
    plans, _ = planned("tiny_moe", get_config("tiny_moe"))
    assert ("masked_matmul_batched_dw", "bfloat16") in {(p.route, p.dtype) for _, p in plans}


# ---------------------------------------------------------------------------
# tuning_cache: TUN001–004 on a cache the tuner wrote, then edited
# ---------------------------------------------------------------------------
_MM = ("masked_matmul", {"M": 256, "K": 128, "N": 64}, {"x": "bfloat16", "w": "bfloat16"}, {})
_FA = ("flash_attention", {"BH": 4, "Sq": 128, "Sk": 128, "d": 128}, {"q": "float32"},
       {"causal": True})


@pytest.fixture()
def cache(tmp_path):
    tuning._reset_for_tests()
    path = tmp_path / "kernels.json"
    tuning.configure(path=str(path))
    for kernel, dims, dtypes, params in (_MM, _FA):
        tuning.store(tuning.search(kernel, dims, dtypes, params, device="cpu"))
    yield path
    tuning._reset_for_tests()


def _edit(path: Path, fn) -> None:
    payload = json.loads(path.read_text())
    fn(payload, [payload["entries"][k] for k in sorted(payload["entries"])])
    path.write_text(json.dumps(payload))


def test_tuning_cache_clean_and_missing(cache, tmp_path):
    assert check_cache(str(cache)) == []
    assert check_cache(str(tmp_path / "absent.json")) == []


def test_tuning_cache_flags_rejected_tiles(cache):
    _edit(cache, lambda p, es: es[1].__setitem__("tiles", {"bm": 96, "bn": 128}))
    found = check_cache(str(cache))
    assert codes(found) == {"TUN001"} and found[0].location.startswith("masked_matmul|")


def test_tuning_cache_flags_shared_memory(cache, monkeypatch):
    """The f32 attention forward's 74624 bytes against a block of 60000:
    the limit of a smaller card, as a cache written on another one meets
    it."""
    monkeypatch.setattr(V, "SMEM_MAX", 60000)
    try:
        found = check_cache(str(cache))
    finally:
        for fn in (V._plan_masked_matmul, V._plan_flash_attention, V._plan_nm_spmm):
            fn.cache_clear()
    assert codes(found) == {"TUN002"} and errors(found)
    assert any(f.location.startswith("flash_attention|") for f in found)


def test_tuning_cache_flags_stale_code_rev(cache):
    _edit(cache, lambda p, es: es[0].__setitem__("code_rev", "0123456789ab"))
    found = check_cache(str(cache))
    assert codes(found) == {"TUN003"} and not errors(found)


@pytest.mark.parametrize("how", ["missing_field", "unknown_kernel", "dims_not_object",
                                 "schema", "entries", "not_json"])
def test_tuning_cache_flags_malformed(cache, how):
    if how == "not_json":
        cache.write_text("{torn")
    else:
        _edit(cache, {
            "missing_field": lambda p, es: es[0].pop("tiles"),
            "unknown_kernel": lambda p, es: es[0].__setitem__("kernel", "conv2d"),
            "dims_not_object": lambda p, es: es[0].__setitem__("dims", [4, 128]),
            "schema": lambda p, es: p.__setitem__("schema", "repro.kernels.tuning/v1"),
            "entries": lambda p, es: p.__setitem__("entries", []),
        }[how])
    found = check_cache(str(cache))
    assert codes(found) == {"TUN004"} and errors(found)


# ---------------------------------------------------------------------------
# the whole run, and the CLI
# ---------------------------------------------------------------------------
def test_run_over_every_config(full_report):
    assert full_report.passes_run == list(PASS_NAMES) == [
        "kernels", "masks", "graph", "sharding", "source_lint", "tuning_cache"]
    assert full_report.configs_checked == CONFIG_IDS
    assert full_report.exit_code("error") == 0
    assert {(f.code, f.config) for f in full_report.findings} == {
        ("KER005", "mamba2_130m"), ("KER005", "tiny_ssm"), ("KER005", "tiny_hybrid")}


@pytest.mark.parametrize("name", CONFIG_IDS)
def test_shipped_config_is_clean(full_report, name):
    """No error, and no mask or graph finding at all, for each config."""
    mine = [f for f in full_report.findings if f.config == name]
    assert not errors(mine)
    assert not [f for f in mine if f.pass_name in ("masks", "graph", "sharding")]


def test_run_rejects_unknown_pass_and_config():
    with pytest.raises(ValueError):
        run(config_names=["tiny_dense"], passes=["jaxpr"])
    with pytest.raises(ValueError):
        run(config_names=["gpt5"], passes=["sharding"])


def test_cli_exit_codes_and_json(capsys):
    from repro_torch.analysis.__main__ import main

    args = ["--configs", "tiny_dense", "--passes", "kernels", "sharding"]
    assert main(args + ["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"]["error"] == 0 and payload["configs"] == ["tiny_dense"]

    extra = ["--extra-config-module", "_torch_analysis_fixtures"]
    assert main(args + extra + ["--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    got = {(f["code"], f["config"]) for f in payload["findings"]}
    assert {("KER001", "bad_tiles"), ("KER001", "bad_head_width"), ("CFG002", "bad_heads")} <= got

    assert main(args + extra + ["--fail-on", "never", "-q"]) == 0
    assert main(args + extra + ["--ignore", "KER001", "--ignore", "CFG002", "-q"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["--passes", "jaxpr"])


def test_cli_module_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--configs", "tiny_dense",
         "--passes", "kernels", "sharding", "tuning_cache", "--tuning-cache",
         str(tmp_path / "none.json"), "--extra-config-module", "_torch_analysis_fixtures"],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 1, out.stderr
    assert "ERROR KER001 [kernels] bad_tiles" in out.stdout
    assert "ERROR CFG002 [sharding] bad_heads config:" in out.stdout
