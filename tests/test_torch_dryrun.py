"""The dry run without HLO (``python -m repro_torch.launch.dryrun``) against
the reference's specs.

The dry run makes a fake process group of its own, so it runs in
subprocesses, never in this one. A module-scoped fixture starts three at
once on the 16 × 16 mesh:

* every config's ``ebft_block`` cell;
* one train shape of each family (the tiny configs' ``train_4k``, one
  microbatch: ``--microbatches 1``; the arguments' bytes do not depend on
  it);
* a planted layout with no sharding rule: tiny_dense's ebft cell with
  one mask laid out apart from its weight (``masked_matmul`` has no rule
  for that), then tiny_vlm's cell, which must still run.

Each record must carry the reference's keys but the HLO ones
(``src/repro/launch/dryrun.py``), and rank 0's ``argument_bytes`` must
equal the bytes of the shards that the reference's own cell
(``repro.launch.steps.build_cell`` on the same abstract mesh) gives its
abstract arguments, leaf by leaf (``NamedSharding.shard_shape``), exactly.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import CONFIG_IDS

FAMILIES_TRAIN = ("tiny_dense", "tiny_moe", "tiny_ssm", "tiny_hybrid", "tiny_vlm", "tiny_encdec")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the planted layout: tiny_dense's ebft cell lays its wq mask over "data"
# where the weight is over "model", a pair ``local_kernels.masked_matmul``
# has no rule for; every other cell is built as it is
PLANT = r"""
import copy, sys
from repro_torch.launch import dryrun, steps as ST
build = ST.build_ebft_cell
def planted(cfg, *a, **k):
    cell = build(cfg, *a, **k)
    if cfg.family == "dense":
        masks = copy.deepcopy(cell.in_specs[2])
        masks["attn"]["wq"] = ("data", None)
        cell.in_specs = (*cell.in_specs[:2], masks, *cell.in_specs[3:])
    return cell
ST.build_ebft_cell = planted
dryrun.main(sys.argv[1:])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, output, {record key: record})} of the three runs."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    jobs = {
        "ebft": ["-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", "ebft_block"],
        "train": ["-m", "repro_torch.launch.dryrun", "--arch", ",".join(FAMILIES_TRAIN),
                  "--shape", "train_4k", "--microbatches", "1"],
        "planted": ["-c", PLANT, "--arch", "tiny_dense,tiny_vlm", "--shape", "ebft_block"],
    }
    procs = {name: subprocess.Popen(
        [sys.executable, *args, "--mesh", "single", "--out", str(tmp / name), "--tag", "t"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in jobs.items()}
    out = {}
    for name, p in procs.items():
        try:
            log = p.communicate(timeout=600)[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        d = tmp / name / "t"
        recs = {f.name[:-len(".json")]: json.loads(f.read_text()) for f in d.glob("*.json")}
        out[name] = (p.returncode, log, recs)
    return out


def _ref_keys():
    """The keys the reference's dry run writes into a cell's record on
    success (``src/repro/launch/dryrun.py``), with its memory keys."""
    return ({"arch", "shape", "mesh", "chips", "kind", "memory_analysis", "cost_analysis",
             "hlo_stats", "roofline", "timing", "fsdp"},
            {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_est"})


def test_every_cell_runs_and_the_records_keep_the_references_keys(runs):
    top, memory = _ref_keys()
    want = (top - {"cost_analysis", "hlo_stats", "roofline"}) | {"hlo"}
    for name in ("ebft", "train"):
        rc, log, recs = runs[name]
        assert rc == 0, log[-3000:]
        assert "dry-run complete; failures=0" in log
        assert len(recs) == (len(CONFIG_IDS) if name == "ebft" else len(FAMILIES_TRAIN))
        for key, rec in recs.items():
            assert set(rec) == want, (key, sorted(rec))
            assert set(rec["memory_analysis"]) == memory
            assert set(rec["timing"]) == {"build_s", "run_s"}
            assert rec["chips"] == 256 and rec["mesh"] == "single"
            assert rec["hlo"] == "not compiled (ROADMAP A.7)"
            ma = rec["memory_analysis"]
            assert ma["peak_bytes_est"] == ma["argument_bytes"] + ma["temp_bytes"]
            assert 0 < ma["alias_bytes"] <= ma["argument_bytes"]


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    """Rank 0's bytes of the reference cell's arguments: each leaf's shard
    shape under its in-sharding on the Auto-axis 16 × 16 abstract mesh."""
    import jax
    from jax.sharding import AbstractMesh, AxisType

    from repro.configs import get_config as ref_get_config
    from repro.launch import steps as RST

    cfg = ref_get_config(arch)
    shape = RST.EBFT_SHAPE if shape_name == "ebft_block" else next(
        s for s in cfg.shapes() if s.name == shape_name)
    mesh = AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cell = RST.build_cell(cfg, shape, mesh)
    total = 0
    for shardings, args in zip(cell.in_shardings, cell.abstract_args):
        sh = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
        leaves = jax.tree_util.tree_leaves(args)
        assert len(sh) == len(leaves)
        total += sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                     for s, x in zip(sh, leaves))
    return total


@pytest.mark.parametrize("case", [f"{a}__ebft_block" for a in CONFIG_IDS]
                         + [f"{a}__train_4k" for a in FAMILIES_TRAIN])
def test_argument_bytes_equal_the_references_specs(runs, case):
    arch, shape_name = case.split("__")
    recs = runs["ebft" if shape_name == "ebft_block" else "train"][2]
    rec = recs[f"{case}__single"]
    assert "error" not in rec, rec.get("traceback")
    assert rec["memory_analysis"]["argument_bytes"] == _reference_argument_bytes(arch, shape_name)


def test_a_planted_layout_with_no_rule_fails_its_cell_and_the_sweep_goes_on(runs):
    rc, log, recs = runs["planted"]
    assert rc == 1, log[-3000:]
    assert "dry-run complete; failures=1" in log
    bad, good = recs["tiny_dense__ebft_block__single"], recs["tiny_vlm__ebft_block__single"]
    assert bad["error"].startswith("ValueError: masked_matmul: mask placements")
    assert "memory_analysis" not in bad and "Traceback" in bad["traceback"]
    assert set(bad) == {"arch", "shape", "mesh", "chips", "kind", "error", "traceback"}
    assert "error" not in good and good["memory_analysis"]["argument_bytes"] > 0
