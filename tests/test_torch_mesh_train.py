"""The sharded train cell, ``launch/train`` on a mesh and checkpoints that
reshard on restore: four gloo ranks on the CPU, against one rank.

One module-scoped fixture starts four processes once (a file store, one
thread each), as ``tests/test_torch_mesh_ebft.py`` does. They run:

* the train cell (``launch/steps.build_train_cell``; tiny_dense at 2
  layers, bf16, seq 64, batch 8, 2 microbatches) on 4 × 1, 2 × 2 and
  1 × 4, with FSDP off and on, against the same cell on one device; a spy
  on the embedding records the rows each rank's forward sees;
* ``launch/train.main`` on 2 × 2: 12 steps, a checkpoint every 6
  (f32), then, after the group is gone, rank 0 resumes it on one device
  to 16; and the reverse: 6 steps saved on one device before the group
  starts, resumed on 4 × 1 to 12. Each against an uninterrupted one-device
  run; and the 2 × 2 checkpoint restored with an explicit ``shardings``
  tree onto 4 × 1.

Stated tolerances: the train cell's loss and grad norm within rtol 2e-3
of one device's, its updated weights within 2^-9 (bf16: the mesh sums
partial products in another order), its AdamW moments, which carry the
gradient (a step moves a weight by about lr whatever the gradient),
within 5e-2 in relative L2 a leaf (measured 6.2e-3 to 2.2e-2; a
gradient left unsummed over the ranks reads 0.85–0.95); the launcher's losses within rtol
2e-3, atol 1e-5 (f32; the reference's ``test_mesh_ebft.py`` tolerance),
and each final weight leaf within 2e-3 of its norm (``_weights_close``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]
MOMENTS_REL = 5e-2  # the train cell's AdamW moments, relative L2 a leaf

RANK_SCRIPT = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out_dir = os.environ["MESH_OUT"]
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import local_kernels as LK
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.launch.mesh import make_abstract_mesh, make_debug_mesh
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adamw

TRAIN = ["--device", "cpu", "--arch", "tiny_dense", "--batch", "8", "--seq", "32",
         "--ckpt-every", "6", "--no-obs"]
spec = lambda steps, ckpt: train.TrainSpec(arch="tiny_dense", steps=steps, batch=8, seq=32,
                                           ckpt_dir=ckpt, ckpt_every=6)
say = lambda *a: None
out = {}
if rank == 0:  # one device, before the group: the run a mesh resumes, and the references
    for name, steps in (("saved_1", 6), ("ref_12", 12), ("ref_16", 16)):
        res = train.run(get_config("tiny_dense"), spec(steps, os.path.join(out_dir, name)),
                        "cpu", say=say)
        out[name] = {"history": res.history}
dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                        rank=rank, world_size=world)

cfg = get_config("tiny_dense").replace(num_layers=2)
shape = ShapeConfig("t", 64, 8, "train")
toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(8, 64))
                       .astype(np.int32))
rows = []
embed = LK.embed
def spy(tokens, table):
    rows.append(tokens.to_local().shape[0] if LK.any_dtensor(tokens) else tokens.shape[0])
    return embed(tokens, table)
LK.embed = spy

def cell_run(mesh, fsdp):
    cell = ST.build_train_cell(cfg, shape, mesh, microbatches=2, fsdp=fsdp)
    params = cell.model.init(torch.Generator().manual_seed(0))
    p, o, m = ST.run_cell(cell, mesh, params, adamw(1e-4).init(params), {"tokens": toks})
    return float(m["loss"]), float(m["grad_norm"]), MeshPlan.gather(p), MeshPlan.gather(o)

def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()

loss1, gn1, p1, o1 = cell_run(make_abstract_mesh((1, 1), ("data", "model")), False)
out["cell_1"] = [loss1, gn1]
for d, m in json.loads(os.environ["MESH_SHAPES"]):
    mesh = make_debug_mesh(d, m, "cpu")
    for fsdp in (False, True):
        rows.clear()
        loss, gn, p, o = cell_run(mesh, fsdp)
        out[f"cell_{d}x{m}_{fsdp}"] = {
            "loss": loss, "grad_norm": gn, "rows": sorted(set(rows)),
            "max_diff": max((a.float() - T.get_path(p1, path).float()).abs().max().item()
                            for path, a in T.leaves_with_path(p)),
            "moments_rel": max(rel_l2(a, T.get_path(o1[k], path))
                               for k in ("m", "v") for path, a in T.leaves_with_path(o[k])),
            "plain": all(type(t) is torch.Tensor for t in T.tensors(p))}
LK.embed = embed

# launch/train under the group: 2 x 2 from scratch, and 4 x 1 resuming a
# one-device run
res = train.main(TRAIN + ["--steps", "12", "--mesh-data", "2", "--mesh-model", "2",
                          "--ckpt-dir", os.path.join(out_dir, "saved_2x2")])
out["run_2x2"] = {"history": res.history, "start": res.start}
res = train.main(TRAIN + ["--steps", "12", "--mesh-data", "4", "--mesh-model", "1",
                          "--ckpt-dir", os.path.join(out_dir, "saved_1")])
out["run_4x1"] = {"history": res.history, "start": res.start,
                  "sums": {"/".join(p): t.double().sum().item()
                           for p, t in T.leaves_with_path(MeshPlan.gather(res.params))}}
# an explicit ``shardings`` tree places the 2 x 2 run's step 12 on 4 x 1 (the
# params; the moments, with no entry, stay plain as their template)
from torch.distributed.tensor import Replicate, Shard
from repro_torch.checkpoint import ckpt as CK
mesh41 = make_debug_mesh(4, 1, "cpu")
p0 = build(get_config("tiny_dense")).init(torch.Generator().manual_seed(0))
tmpl = {"params": p0, "opt_state": adamw(1e-3).init(p0)}
want = T.tree_map(lambda t: [Shard(0) if t.dim() and t.shape[0] % 4 == 0 else Replicate(),
                             Replicate()], p0)
got = CK.restore(os.path.join(out_dir, "saved_2x2"), tmpl, step=12,
                 shardings={"params": T.tree_map(lambda pl: (mesh41, pl), want)})
plain = CK.restore(os.path.join(out_dir, "saved_2x2"), tmpl, step=12)
out["shardings"] = {
    "placed": all(list(t.placements) == T.get_path(want, p)
                  for p, t in T.leaves_with_path(got["params"])),
    "moments_plain": all(type(t) is torch.Tensor for t in T.tensors(got["opt_state"])),
    "equal": all(torch.equal(MeshPlan.gather(t), T.get_path(plain, p))
                 for p, t in T.leaves_with_path(got))}
dist.destroy_process_group()
if rank == 0:  # the 2 x 2 run resumed on one device
    res = train.run(get_config("tiny_dense"), spec(16, os.path.join(out_dir, "saved_2x2")),
                    "cpu", say=say)
    out["resumed_1"] = {"start": res.start}
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
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
    res[0]["stdout"] = outs
    res[0]["dir"] = tmp
    return res


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_train_cell_matches_one_device(ranks, mesh, fsdp):
    loss1, gn1 = ranks[0]["cell_1"]
    for r in ranks:
        rec = r[f"cell_{mesh}_{fsdp}"]
        np.testing.assert_allclose([rec["loss"], rec["grad_norm"]], [loss1, gn1], rtol=2e-3)
        assert rec["plain"] and rec["max_diff"] <= 2.0 ** -9, rec["max_diff"]
        assert rec["moments_rel"] <= MOMENTS_REL, rec["moments_rel"]
        assert rec == ranks[0][f"cell_{mesh}_{fsdp}"]


@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_constrain_microbatch_gives_each_rank_its_rows(ranks, mesh):
    """Batch 8 in 2 microbatches over a data axis of d: each rank's forward
    sees 8 / (2 · d) rows, never the whole microbatch."""
    data = int(mesh.split("x")[0])
    for fsdp in (False, True):
        assert ranks[0][f"cell_{mesh}_{fsdp}"]["rows"] == [8 // (2 * data)]


def test_launcher_on_2x2_then_resumed_on_one_device(ranks):
    r0 = ranks[0]
    assert r0["run_2x2"]["start"] == 0 and r0["resumed_1"]["start"] == 12
    # rank 0 alone prints, the reference's line first
    assert r0["stdout"][0].count("devices=4 mesh={'data': 2, 'model': 2}") == 1
    assert all("devices=" not in out for out in r0["stdout"][1:])
    got, ref = r0["run_2x2"]["history"], r0["ref_16"]["history"]
    assert [s for s, _ in got] == [0, 10]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in ref[:2]], rtol=2e-3, atol=1e-5)
    _weights_close(r0["dir"] / "saved_2x2", r0["dir"] / "ref_16", 16)


def test_launcher_saved_on_one_device_resumed_on_4x1(ranks):
    r0 = ranks[0]
    assert r0["run_4x1"]["start"] == 6
    assert all(r["run_4x1"] == r0["run_4x1"] for r in ranks)
    _weights_close(r0["dir"] / "saved_1", r0["dir"] / "ref_12", 12)


def _weights_close(got_dir, ref_dir, step):
    """The two runs' final checkpoints (written by rank 0 or one device),
    leaf by leaf: the difference's norm within 2e-3 of the leaf's, plus
    1e-5 a element. Element by element a few near-zero embedding entries
    move by up to 2.3e-4 (Adam scales a near-zero gradient's
    summation-order noise up to the step size)."""
    got, ref = (np.load(d / f"step_{step:08d}" / "arrays.npz") for d in (got_dir, ref_dir))
    names = json.loads((ref_dir / f"step_{step:08d}" / "manifest.json").read_text())["names"]
    for i, name in enumerate(names):
        a, b = got[f"leaf_{i}"].astype(np.float64), ref[f"leaf_{i}"].astype(np.float64)
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b) + 1e-5 * np.sqrt(b.size), name


def test_checkpoint_from_2x2_restores_in_the_reference(ranks):
    """The reference's ``restore`` reads the 2 × 2 run's step 12 on one CPU
    device bit for bit against the port's, and its manifest carries the
    reference's ``str(PartitionSpec)`` of every sharded leaf."""
    import jax
    from jax.sharding import PartitionSpec

    from repro.checkpoint import ckpt as RCK
    from repro.configs import get_config as ref_get_config
    from repro.distributed import sharding as RSH
    from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
    from repro.models.model import build as ref_build
    from repro.optim.optimizers import adamw as ref_adamw
    from repro_torch import tree as T
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.optim.optimizers import adamw

    d = str(ranks[0]["dir"] / "saved_2x2")
    m = ref_build(ref_get_config("tiny_dense"))
    params = m.init(jax.random.PRNGKey(0))
    ref = RCK.restore(d, {"params": params, "opt_state": ref_adamw(1e-3).init(params)}, step=12)
    model = build(get_config("tiny_dense"))
    p = model.init(__import__("torch").Generator().manual_seed(0))
    port = CK.restore(d, {"params": p, "opt_state": adamw(1e-3).init(p)}, step=12)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in ref_leaves:
        names = tuple(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), T.get_path(port, names).numpy())
    manifest = json.loads((ranks[0]["dir"] / "saved_2x2" / "step_00000012" /
                           "manifest.json").read_text())
    specs = RSH.param_pspecs(jax.eval_shape(lambda: params),
                             ref_abstract_mesh((2, 2), ("data", "model")))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        for prefix in ("params/", "opt_state/m/", "opt_state/v/"):  # moments as their params
            want[prefix + name] = str(PartitionSpec(*spec))
    want["opt_state/step"] = None
    assert dict(zip(manifest["names"], manifest["source_specs"])) == want


def test_restore_places_leaves_by_explicit_shardings(ranks):
    for r in ranks:
        assert r["shardings"] == {"placed": True, "moments_plain": True, "equal": True}
