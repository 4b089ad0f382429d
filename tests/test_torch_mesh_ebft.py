"""EBFT on a device mesh (``core/ebft.py`` with an active ``MeshPlan``):
four gloo ranks on the CPU, against one rank and against the reference's
``MeshPlan``.

One module-scoped fixture starts four processes once (a file store, one
thread each). They run tiny_dense, magnitude 0.5, EBFT at lr 1e-2, 2
epochs, microbatch 8 (the reference's ``tests/test_mesh_ebft.py``
settings): once on one rank and once on each of a 4 × 1 and a 2 × 2
mesh. Stated tolerance: the per-block loss histories within rtol 2e-3,
atol 1e-5 of one rank's (the reference test's); the tuned weights of
every rank equal bit for bit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import ebft
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.model import build

WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]  # 1 x 4: one head a rank

RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                        rank=rank, world_size=world)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import ebft
from repro_torch.core.masks import prune
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.launch.mesh import make_ebft_plan
from repro_torch.models.model import build

cfg = get_config("tiny_dense")
model = build(cfg)
params = model.init(torch.Generator().manual_seed(0))
calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(16, 32)).astype(np.int32)
masks, pruned = prune(model, params, calib, method="magnitude", sparsity=0.5)
base = dict(lr=1e-2, epochs=2, microbatch=8, patience=2)
out = {}
tuned, reps = ebft.finetune(model, params, pruned, masks, calib, ebft.EBFTConfig(**base))
out["1x1"] = {"reports": [r.asdict() for r in reps],
              "tuned": {"/".join(p): t.double().sum().item() for p, t in T.leaves_with_path(tuned)}}

seen = []
plain = MM._call
def spy(fn, a, b, c, tiles=None, **kw):
    seen.append((fn, tuple(a.shape), tuple(b.shape)))
    return plain(fn, a, b, c, tiles, **kw)
MM._call = spy

# each gradient as Adam receives it: a DTensor, summed over the data axes
# (no Partial placement left)
grads_seen = []
adam = ebft.adam
def spy_adam(lr):
    opt = adam(lr)
    def update(grads, state, params=None):
        grads_seen.extend(any(p.is_partial() for p in g.placements)
                          for g in T.tensors(grads) if hasattr(g, "placements"))
        return opt.update(grads, state, params)
    return type(opt)(opt.init, update)
ebft.adam = spy_adam

for data, model_axis in json.loads(os.environ["MESH_SHAPES"]):
    seen.clear()
    grads_seen.clear()
    plan = make_ebft_plan(data, model_axis, device_type="cpu")
    tuned, reps = ebft.finetune(model, params, pruned, masks, calib,
                                ebft.EBFTConfig(**base, mesh_plan=plan))
    out[f"{data}x{model_axis}"] = {
        "devices": plan.device_count, "reports": [r.asdict() for r in reps],
        "plain": all(type(t) is torch.Tensor for t in T.tensors(tuned)),
        "tuned": {"/".join(p): t.double().sum().item() for p, t in T.leaves_with_path(tuned)},
        "kernel_shapes": sorted(set(seen)),
        "grads": len(grads_seen), "partial_grads": sum(grads_seen),
    }
MM._call = plain
ebft.adam = adam

# a kernel on DTensors: a layout without a rule raises, and the attention
# wrappers take none (layers.attend maps their shards)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch.mesh import make_debug_mesh
mesh = make_debug_mesh(2, 2, "cpu")
x = distribute_tensor(torch.randn(8, 16), mesh, [Replicate(), Shard(1)], src_data_rank=None)
w = distribute_tensor(torch.randn(16, 8), mesh, [Replicate(), Replicate()], src_data_rank=None)
m = distribute_tensor(torch.ones(16, 8, dtype=torch.bool), mesh, [Replicate(), Replicate()],
                      src_data_rank=None)
raised = {}
for name, call, exc in (
        ("masked_matmul", lambda: MM.masked_matmul(x, w, m), ValueError),
        ("flash_attention_bshd", lambda: FA.flash_attention_bshd(*[
            distribute_tensor(torch.randn(2, 4, 2, 8), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)] * 3), TypeError)):
    try:
        call()
        raised[name] = False
    except exc:
        raised[name] = True
out["dtensor_refusals"] = raised
with open(os.path.join(os.environ["MESH_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)

# ebft_run on a 2 x 2 mesh of these ranks: rank 0 alone prints and writes
from repro_torch.launch import ebft_run
print("EBFT_RUN", flush=True)
ebft_run.main(["--arch", "tiny_dense", "--device", "cpu", "--mesh-data", "2", "--mesh-model",
               "2", "--pretrain-steps", "0", "--calib-samples", "16", "--seq", "32",
               "--epochs", "1", "--kernel-tune", "off",
               "--bench-out", os.path.join(os.environ["MESH_OUT"], "bench.json")])
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, by rank."""
    tmp = tmp_path_factory.mktemp("mesh_ebft")
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               WORLD_SIZE=str(WORLD), MESH_STORE=str(tmp / "store"), MESH_OUT=str(tmp),
               MESH_SHAPES=json.dumps(MESHES), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs, errs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    for r, out in zip(res, outs):
        r["cli_stdout"] = out.split("EBFT_RUN", 1)[1]
    res[0]["bench"] = json.loads((tmp / "bench.json").read_text())
    return res


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_mesh_histories_match_one_rank(ranks, mesh):
    single, got = ranks[0]["1x1"]["reports"], ranks[0][mesh]["reports"]
    assert len(got) == len(single) == 2
    for rs, rm in zip(single, got):
        assert rm["epochs_run"] == rs["epochs_run"] and rm["early_stop"] == rs["early_stop"]
        np.testing.assert_allclose(rm["history"], rs["history"], rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose([rm["loss_before"], rm["loss_after"]],
                                   [rs["loss_before"], rs["loss_after"]], rtol=2e-3, atol=1e-5)
    # every rank returns the same whole tensors, within the tolerance of one rank's
    for r in ranks:
        assert r[mesh]["plain"] and r[mesh]["tuned"] == ranks[0][mesh]["tuned"]
        assert r[mesh]["reports"] == ranks[0][mesh]["reports"]
    one = ranks[0]["1x1"]["tuned"]
    np.testing.assert_allclose([ranks[0][mesh]["tuned"][k] for k in one], list(one.values()),
                               rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_mesh_accounting(ranks, mesh):
    rec = ranks[0][mesh]
    data, model_axis = (int(x) for x in mesh.split("x"))
    for r in rec["reports"]:
        assert r["device_dispatches"] == r["dispatches"] * rec["devices"]
        # the gradient all-reduce over the data axis is real wire traffic
        assert (r["collective_bytes"] > 0) == (data > 1)
        if model_axis > 1:  # model-axis sharding splits the live block
            assert r["live_bytes_per_shard"] < r["live_bytes"]
        else:  # pure data parallelism replicates it
            assert r["live_bytes_per_shard"] == r["live_bytes"]
    for rm, rs in zip(rec["reports"], ranks[0]["1x1"]["reports"]):
        assert rm["dispatches"] == rs["dispatches"] and rs["collective_bytes"] == 0
    # every gradient reaches Adam summed over the data axes: the reduction
    # the reference's GSPMD inserts, explicit here
    assert rec["grads"] > 0 and rec["partial_grads"] == 0


def test_kernels_run_on_local_shards(ranks):
    """The masked matmul sees each rank's rows (8 rows of 32 tokens a
    microbatch over the data axis) everywhere, and in the tuning step (its
    dW) the live block's heads and ff columns over the model axis. The
    stream advances run the whole block."""
    cfg = get_config("tiny_dense")
    d, ff, qkv = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.resolved_head_dim
    for mesh, rows, (q, f) in (("4x1", 8 // 4 * 32, (qkv, ff)),
                               ("2x2", 8 // 2 * 32, (qkv // 2, ff // 2))):
        seen = ranks[0][mesh]["kernel_shapes"]
        assert {fn for fn, *_ in seen} == {"masked_matmul", "masked_matmul_dx",
                                            "masked_matmul_dw"}
        assert {a[0] for fn, a, _ in seen} == {rows}
        dw = {(tuple(a), tuple(b)) for fn, a, b in seen if fn == "masked_matmul_dw"}
        assert dw == {((rows, d), (rows, q)), ((rows, q), (rows, d)),
                      ((rows, d), (rows, f)), ((rows, f), (rows, d))}, dw


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (16, 16), (3, 2)])
def test_explain_matches_reference(shape):
    """Every leaf's (path, spec, sharded?) of block 0, and the degraded
    leaves among them, equal the reference's ``MeshPlan.explain`` on an
    abstract mesh of the same shape."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.distributed.meshplan import MeshPlan as RefPlan
    from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
    from repro.models.model import build as ref_build

    m = ref_build(ref_get_config("tiny_dense"))
    block0 = jax.eval_shape(lambda: m.get_block(m.init(jax.random.PRNGKey(0)), 0))
    ref = RefPlan.from_mesh(ref_abstract_mesh(shape, ("data", "model"))).explain(block0)
    port = MeshPlan.from_mesh(make_abstract_mesh(shape, ("data", "model"))).explain(
        SH.abstract_params(build(get_config("tiny_dense")), block=0))
    assert sorted(port) == sorted((p, tuple(s), ok) for p, s, ok in ref)
    stream = {"h": jax.ShapeDtypeStruct((2, 8, 32, 64), np.float32)}
    ref_st = RefPlan.from_mesh(ref_abstract_mesh(shape, ("data", "model"))).explain(
        stream, stacked=True)
    port_st = MeshPlan.from_mesh(make_abstract_mesh(shape, ("data", "model"))).explain(
        {"h": SH.ShapeLeaf((2, 8, 32, 64))}, stacked=True)
    assert [(s, ok) for _, s, ok in port_st] == [(tuple(s), ok) for _, s, ok in ref_st]


def test_plan_accounting_matches_reference():
    """``describe``, the sizes, ``sharded_bytes`` and ``allreduce_bytes``
    on abstract meshes, against the reference's."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.distributed.meshplan import MeshPlan as RefPlan
    from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
    from repro.models.model import build as ref_build

    for shape in ((4, 1), (2, 2), (16, 16)):
        m = ref_build(ref_get_config("llama_7b"))
        block0 = jax.eval_shape(lambda: m.get_block(m.init(jax.random.PRNGKey(0)), 0))
        ref = RefPlan.from_mesh(ref_abstract_mesh(shape, ("data", "model")))
        port = MeshPlan.from_mesh(make_abstract_mesh(shape, ("data", "model")))
        shapes = SH.abstract_params(build(get_config("llama_7b")), block=0)
        assert port.describe() == ref.describe()
        assert (port.active, port.device_count, port.data_size, port.model_size) == \
            (ref.active, ref.device_count, ref.data_size, ref.model_size)
        assert port.sharded_bytes(shapes) == ref.sharded_bytes(block0)
        assert port.allreduce_bytes(12345) == ref.allreduce_bytes(12345)
    assert MeshPlan.single().describe() == RefPlan.single().describe()
    assert not MeshPlan.single().active and MeshPlan.single().explain({}) == []


def test_active_plan_on_other_families_raises():
    """The dense, MoE, SSM and hybrid families run on a mesh
    (``tests/test_torch_mesh_families.py``); an active plan on the VLM
    raises before any work, and never runs unsharded."""
    plan = MeshPlan.from_mesh(make_abstract_mesh((2, 2), ("data", "model")))
    assert plan.active
    cfg = get_config("tiny_vlm")
    model = build(cfg)
    import torch

    params = model.init(torch.Generator().manual_seed(0))
    calib = np.zeros((8, 16), np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.8e"):
        ebft.finetune(model, params, params, params, calib, ebft.EBFTConfig(mesh_plan=plan))


def test_ebft_run_on_a_mesh(ranks):
    """``ebft_run --mesh-data 2 --mesh-model 2`` under four ranks: rank 0
    alone prints and writes the artifact, whose ``mesh`` section is the
    plan's, and whose manifest carries the requested axes."""
    out = ranks[0]["cli_stdout"]
    assert "calibration mesh: {'data': 2, 'model': 2} (4 devices)" in out and "EBFT ppl" in out
    assert all(r["cli_stdout"].strip() == "" for r in ranks[1:])
    bench = ranks[0]["bench"]
    mesh = bench["mesh"]
    assert (mesh["devices"], mesh["axes"], mesh["active"]) == (4, {"data": 2, "model": 2}, True)
    assert mesh["collective_bytes_total"] == sum(b["collective_bytes"] for b in bench["blocks"]) > 0
    assert mesh["peak_live_block_bytes_per_shard"] < bench["ebft"]["peak_live_block_bytes"]
    assert bench["manifest"]["mesh"] == {"data": 2, "model": 2}


def test_ebft_run_refuses_a_mesh_larger_than_the_group(tmp_path):
    """One process asked for a 2 × 1 mesh: the error says to start the run
    under torchrun (the reference's device-count error)."""
    from repro_torch.launch import ebft_run
    from repro_torch.launch.mesh import make_ebft_plan

    assert make_ebft_plan(1, 1) == MeshPlan.single()
    assert make_ebft_plan(0, 1) == MeshPlan.single()  # data=0: every rank of one
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        ebft_run.main(["--arch", "tiny_dense", "--device", "cpu", "--mesh-data", "2",
                       "--pretrain-steps", "0", "--bench-out", ""])


def test_kernels_refuse_dtensor_layouts_without_a_rule(ranks):
    """A masked matmul of a column-sharded x against a replicated w has no
    rule and raises; the flash wrappers raise on any DTensor, so no kernel
    is ever taken apart into plain ops on one."""
    assert ranks[0]["dtensor_refusals"] == {"masked_matmul": True, "flash_attention_bshd": True}
