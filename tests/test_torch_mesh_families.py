"""The MoE, SSM and hybrid families on a device mesh: the EBFT walk, the
four cells of ``launch/steps.py`` and ``launch/train``, four gloo ranks
on the CPU against one process of the port; and, in this process, the
two local rules against their whole-tensor counterparts.

One module-scoped fixture starts four processes once (a file store, one
thread each), as ``tests/test_torch_mesh_ebft.py`` does. They run:

* the walk (magnitude 0.5, 2 epochs, microbatch 8, 16 segments of 32):
  tiny_moe (lr 2e-4) on 2 × 2, 4 × 1 (its one dispatch group spans the
  data ranks) and 1 × 4; a tiny_moe with 6 experts on 1 × 4 (E does not
  divide: the experts split along ff); tiny_ssm and tiny_hybrid (lr
  1e-2) on 2 × 2, against one process;
* one MoE layer on 4 × 1 and 2 × 2 at one dispatch group and on 2 × 2 at
  two, each rank's kept assignments gathered against one process's;
* the expert-batched masked matmul on DTensor slabs (split over E, and
  column- and row-parallel over ff), values and gradients;
* the train, ebft, prefill and decode cells of each family on 2 × 2
  (bf16; the train and serving cells again in f32), against the same
  cell's function on plain tensors (the cells give the MoE one dispatch
  group per data shard, so the one process runs the mesh's config);
* ``launch/train.run`` of tiny_moe on 2 × 2 for 2 steps (one dispatch
  group over the data ranks), against one process.

Stated tolerances: the walks' histories within rtol 2e-3, atol 1e-5 of
one process's, with the same ``epochs_run`` and ``early_stop`` (the
reference's ``tests/test_mesh_ebft.py``); the kept assignments equal;
the cells as ``tests/test_torch_mesh_cells.py`` and
``test_torch_mesh_train.py`` hold the dense ones: losses within rtol
2e-3, updated weights within 2^-9, Adam's moments within 3e-2 (ebft) and
AdamW's within 0.25 (train: ``BF16_TRAIN_MOMENTS_REL``) in relative L2
a leaf, logits within 3e-2 (6e-2 for the MoE); the same train and serve
cells in f32, where bf16's rounding does not hide the rules' error:
AdamW's moments within 5e-2 (``test_torch_mesh_train.py``'s), logits
within 1e-4; ``launch/train``'s losses within rtol 2e-3, atol 1e-5, and
its f32 AdamW moments within 5e-2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_thread_module  # noqa: F401

WORLD = 4
WALKS = [("tiny_moe", 2, 2), ("tiny_moe", 4, 1), ("tiny_moe", 1, 4), ("tiny_moe_e6", 1, 4),
         ("tiny_ssm", 2, 2), ("tiny_hybrid", 2, 2)]
FAMILIES = ("tiny_moe", "tiny_ssm", "tiny_hybrid")
EBFT_MOMENTS_REL = 3e-2   # tests/test_torch_mesh_cells.py's MOMENTS_REL
TRAIN_MOMENTS_REL = 5e-2  # tests/test_torch_mesh_train.py's MOMENTS_REL
# the bf16 train cells of these families: AdamW's moments of the leaves
# whose gradients are smallest (the SSM's A_log, D, in_dt: norms about
# 1e-4) and, in the MoE, of every leaf (a bf16 rounding of the router's
# input flips near-tie tokens' top k) move by 3-17% in relative L2 a leaf
# (measured; loss and grad norm within 2e-4). The same cells in f32 read
# under 1% and are held to TRAIN_MOMENTS_REL; a gradient left unsummed
# over the data ranks reads 0.7 and above
BF16_TRAIN_MOMENTS_REL = 0.25

RANK_SCRIPT = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                        rank=rank, world_size=world)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ebft
from repro_torch.core.masks import prune
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh, make_ebft_plan
from repro_torch.models import moe as MOE
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adam, adamw

ARCHS = {a: get_config(a) for a in ("tiny_moe", "tiny_ssm", "tiny_hybrid")}
ARCHS["tiny_moe_e6"] = ARCHS["tiny_moe"].replace(moe_num_experts=6)
out = {"walks": {}, "one": {}}
seen = []
call = MM._call
def spy(fn, a, b, c, tiles=None, **kw):
    seen.append((fn, list(a.shape), list(b.shape)))
    return call(fn, a, b, c, tiles, **kw)
MM._call = spy

def sums(tree):
    return {"/".join(p): t.double().sum().item() for p, t in T.leaves_with_path(tree)}

def walk(name, plan):
    cfg = ARCHS[name]
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(16, 32)).astype(np.int32)
    masks, pruned = prune(model, params, calib, method="magnitude", sparsity=0.5)
    lr = 2e-4 if cfg.family == "moe" else 1e-2
    seen.clear()
    tuned, reps = ebft.finetune(model, params, pruned, masks, calib,
                                ebft.EBFTConfig(lr=lr, epochs=2, microbatch=8, mesh_plan=plan))
    return {"reports": [r.asdict() for r in reps], "tuned": sums(tuned),
            "plain": all(type(t) is torch.Tensor for t in T.tensors(tuned)),
            "batched": sorted({(fn, tuple(a), tuple(b)) for fn, a, b in seen if len(a) == 3})}

for name, d, m in json.loads(os.environ["WALKS"]):
    if rank == 0 and name not in out["one"]:
        out["one"][name] = walk(name, None)
    out["walks"][f"{name}_{d}x{m}"] = walk(name, make_ebft_plan(d, m, device_type="cpu"))
MM._call = call

# one MoE layer: each rank's kept assignments against one process's
kept = {}
orig_scan = MOE.scan_positions
rec = []
def scan_spy(flat_idx, E, C, offset=None):
    pos, keep = orig_scan(flat_idx, E, C, offset)
    rec.append(keep.tolist())
    return pos, keep
MOE.scan_positions = scan_spy
g = torch.Generator().manual_seed(5)
for d, m, groups in ((4, 1, 1), (2, 2, 1), (2, 2, 2)):
    cfg = ARCHS["tiny_moe"].replace(moe_dispatch_groups=groups, moe_capacity_factor=1.0)
    model = build(cfg)
    p = model.get_block(model.init(torch.Generator().manual_seed(0)), 1)["moe"]
    x = torch.randn(8, 32, cfg.d_model, generator=g)
    rec.clear()
    one, aux1 = MOE.moe_mlp(p, x, cfg)
    whole = [k for r in rec for k in r]
    mesh = make_debug_mesh(d, m, "cpu")
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
    pd = ST.place(p, SH.param_pspecs(p, mesh), mesh)
    rec.clear()
    with implicit_replication(), AS.policy(AS.make_mesh_policy(mesh)):
        got, aux = MOE.moe_mlp(pd, xd, cfg)
    pieces = [None] * world
    dist.all_gather_object(pieces, (mesh.get_local_rank(0), mesh.get_local_rank(1),
                                    [k for r in rec for k in r]))
    # the data ranks' pieces in token order, one model rank's each (all route alike)
    mine = [k for dr, mr, ks in sorted(pieces) if mr == 0 for k in ks]
    kept[f"{d}x{m}_g{groups}"] = {
        "equal": mine == whole, "dropped": whole.count(False), "n": len(whole),
        "out": (MeshPlan.gather(got) - one).abs().max().item(),
        "aux": [float(MeshPlan.gather(aux)), float(aux1)]}
MOE.scan_positions = orig_scan
out["kept"] = kept

# the expert-batched masked matmul on DTensor slabs: over E, column- and
# row-parallel over ff; forward and gradients against the plain tensors'
mesh = make_debug_mesh(1, 4, "cpu")
E, C, K, N = 4, 6, 16, 8
x, w = torch.randn(E, C, K, generator=g), torch.randn(E, K, N, generator=g)
msk = torch.rand(E, K, N, generator=g) < 0.5
dy = torch.randn(E, C, N, generator=g)
def grads(xx, ww, mm):
    xx, ww = (t.detach().requires_grad_(True) for t in (xx, ww))
    y, dyy = MM.masked_matmul_batched(xx, ww, mm), dy
    if hasattr(y, "placements"):  # whole on every rank
        y = y.redistribute(mesh, [Replicate()] * 2)
        dyy = distribute_tensor(dy, mesh, [Replicate()] * 2, src_data_rank=None)
    gx, gw = torch.autograd.grad((y * dyy).sum(), (xx, ww))
    return [MeshPlan.gather(t) for t in (y, gx, gw)]
batched = {}
want = grads(x, w, msk)
for label, xp, wp in (("experts", [Replicate(), Shard(0)], [Replicate(), Shard(0)]),
                      ("columns", [Replicate(), Replicate()], [Replicate(), Shard(2)]),
                      ("rows", [Replicate(), Shard(2)], [Replicate(), Shard(1)])):
    xd, wd, md = (distribute_tensor(t, mesh, p, src_data_rank=None)
                  for t, p in ((x, xp), (w, wp), (msk, wp)))
    got = grads(xd, wd, md)
    batched[label] = max((a - b).abs().max().item() for a, b in zip(got, want))
out["batched_dtensor"] = batched

# the cells on 2 x 2 against the same cells' functions on plain tensors
mesh = make_debug_mesh(2, 2, "cpu")
B, P, NDEC = 8, 32, 4
def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()
def clone(tree):
    return T.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
def state_diff(got, one):
    return max((a.float() - T.get_path(one, p).float()).abs().max().item()
               for p, a in T.leaves_with_path(got))
def moments_rel(got, one):
    return max(rel_l2(a, T.get_path(one[k], p)) for k in ("m", "v")
               for p, a in T.leaves_with_path(got[k]))
def names(placements):
    return [f"S{p.dim}" if p.is_shard() else "P" if p.is_partial() else "R" for p in placements]

def train_cell(cfg, toks):
    cell = ST.build_train_cell(cfg, ShapeConfig("t", P, B, "train"), mesh, lr=1e-4)
    params = cell.model.init(torch.Generator().manual_seed(0))
    opt = adamw(1e-4).init(params)
    p1, o1, m1 = cell.fn(clone(params), clone(opt), {"tokens": toks})
    p, o, m = ST.run_cell(cell, mesh, params, opt, {"tokens": toks})
    return {"loss": [float(m["loss"]), float(m1["loss"])],
            "grad_norm": [float(m["grad_norm"]), float(m1["grad_norm"])],
            "weights": state_diff(MeshPlan.gather(p), p1),
            "moments": moments_rel(MeshPlan.gather(o), o1)}

def ebft_cell(cfg):
    cell = ST.build_ebft_cell(cfg, ShapeConfig("e", P, B, "ebft"), mesh)
    i = cell.model.num_blocks // 2
    bw = T.tree_map(torch.clone, cell.model.get_block(cell.model.init(
        torch.Generator().manual_seed(1)), i))
    gm = torch.Generator().manual_seed(2)
    masks = T.tree_map(lambda t: ((torch.rand(t.shape, generator=gm) < 0.5) | (t.dim() < 2))
                       .to(torch.bfloat16), bw)
    h, tgt = (torch.randn(B, P, cfg.d_model, generator=gm).to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(P, dtype=torch.int32)[None]
    ost = adam(2e-4).init(bw)
    nb1, os1, l1 = cell.fn(clone(bw), clone(ost), masks, h, tgt, pos)
    nb, os_, l = ST.run_cell(cell, mesh, bw, ost, masks, h, tgt, pos)
    return {"block": i, "loss": [float(l), float(l1)],
            "weights": state_diff(MeshPlan.gather(nb), nb1),
            "moments": moments_rel(MeshPlan.gather(os_), os1)}

def serve_cells(cfg, toks):  # prefill, then greedy decode fed one process's tokens
    pc = ST.build_prefill_cell(cfg, ShapeConfig("p", P, B, "prefill"), mesh)
    dc = ST.build_decode_cell(cfg, ShapeConfig("d", P + NDEC - 1, B, "decode"), mesh)
    sp = pc.model.init(torch.Generator().manual_seed(3))
    def serve(run, feed=None):
        state = pc.model.init_serve_state(B, P + NDEC, "cpu")
        logits, state = run(pc, sp, {"tokens": toks}, state)
        steps = [logits[:, -1].float()]
        for t in range(NDEC):
            tok = feed[t] if feed else steps[-1].argmax(-1)[:, None].to(torch.int32)
            logits, state = run(dc, sp, tok, state)
            steps.append(logits[:, -1].float())
        return torch.stack(steps), state
    one, _ = serve(lambda c, *a: c.fn(*a))
    got, state = serve(lambda c, *a: ST.run_cell(c, mesh, *a),
                       [one[t].argmax(-1)[:, None].to(torch.int32) for t in range(NDEC)])
    top2 = one.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 6e-2
    return {"logits": (got - one).abs().max().item(), "len": state["len"],
            "plain": type(got) is torch.Tensor, "clear": int(clear.sum()),
            "tokens": bool((got.argmax(-1)[clear] == one.argmax(-1)[clear]).all()),
            "states": {"/".join(p_): [list(t.to_local().shape), names(t.placements)]
                       for p_, t in T.leaves_with_path(state) if hasattr(t, "to_local")}}

cells = {}
adapt = ST.adapt_config
for name in ("tiny_moe", "tiny_ssm", "tiny_hybrid"):
    cfg = ARCHS[name]
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, P))
                           .astype(np.int32))
    cells[name] = {"train": train_cell(cfg, toks), "ebft": ebft_cell(cfg),
                   "serve": serve_cells(cfg, toks)}
    # the same cells with the production numerics in f32 (weights and
    # activations): the rules' own error, without bf16's rounding
    ST.adapt_config = lambda *a, **k: adapt(*a, **k).replace(dtype="float32",
                                                             param_dtype="float32")
    cells[name]["train_f32"] = train_cell(cfg, toks)
    cells[name]["serve_f32"] = serve_cells(cfg, toks)
    ST.adapt_config = adapt
out["cells"] = cells

# launch/train on 2 x 2: one dispatch group over the data ranks
spec = train.TrainSpec(arch="tiny_moe", steps=2, batch=8, seq=32)
res = train.run(ARCHS["tiny_moe"], spec, "cpu", say=lambda *a: None, mesh=mesh, log_every=1)
out["launch"] = {"history": res.history, "sums": sums(MeshPlan.gather(res.params))}
launch_opt = MeshPlan.gather(res.opt_state)
if rank == 0:
    res = train.run(ARCHS["tiny_moe"], spec, "cpu", say=lambda *a: None, log_every=1)
    out["launch_one"] = {"history": res.history, "sums": sums(res.params),
                         "moments": moments_rel(launch_opt, res.opt_state)}
with open(os.path.join(os.environ["MESH_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, by rank."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               WORLD_SIZE=str(WORLD), MESH_STORE=str(tmp / "store"), MESH_OUT=str(tmp),
               WALKS=json.dumps(WALKS), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=400)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


@pytest.mark.parametrize("walk", [f"{a}_{d}x{m}" for a, d, m in WALKS])
def test_walk_on_a_mesh_matches_one_process(ranks, walk):
    single = ranks[0]["one"][walk.rsplit("_", 1)[0]]
    got = ranks[0]["walks"][walk]
    assert len(got["reports"]) == len(single["reports"]) > 0
    for rs, rm in zip(single["reports"], got["reports"]):
        assert (rm["index"], rm["kind"]) == (rs["index"], rs["kind"])
        assert rm["epochs_run"] == rs["epochs_run"] and rm["early_stop"] == rs["early_stop"]
        np.testing.assert_allclose(rm["history"], rs["history"], rtol=2e-3, atol=1e-5)
        assert rm["device_dispatches"] == rm["dispatches"] * 4
    for r in ranks:  # every rank returns the same whole tensors
        assert r["walks"][walk]["plain"] and r["walks"][walk]["tuned"] == got["tuned"]
    one = single["tuned"]
    np.testing.assert_allclose([got["tuned"][k] for k in one], list(one.values()),
                               rtol=2e-3, atol=1e-3)


def test_hybrid_shared_block_is_tuned_last_on_every_site(ranks):
    """tiny_hybrid (5 Mamba blocks, the shared block after every 2): the
    shared block's report comes last, as on one process, tuned on both
    sites' microbatches."""
    reps = ranks[0]["walks"]["tiny_hybrid_2x2"]["reports"]
    assert [r["kind"] for r in reps] == ["mamba"] * 5 + ["shared"]
    assert reps[-1]["index"] == 5


def test_expert_slabs_run_on_local_shards(ranks):
    """The routed experts' batched masked GEMMs (forward, dX, dW) run on
    each rank's own slabs: E / 2 experts a rank on 2 × 2, E / 4 on 1 × 4,
    all E on 4 × 1, and all 6 at a quarter of ff on 1 × 4 when E does not
    divide."""
    def slabs(walk):
        return {a[0] for fn, a, _ in ranks[0]["walks"][walk]["batched"]}
    assert set(fn for fn, *_ in ranks[0]["walks"]["tiny_moe_2x2"]["batched"]) == {
        "masked_matmul", "masked_matmul_dx", "masked_matmul_dw"}
    assert slabs("tiny_moe_2x2") == {8, 4}  # the streams run every expert; the tuning, its own
    assert slabs("tiny_moe_1x4") == {8, 2}
    assert slabs("tiny_moe_4x1") == {8}
    weights = {tuple(b) for fn, _, b in ranks[0]["walks"]["tiny_moe_e6_1x4"]["batched"]
               if fn == "masked_matmul"}
    # the streams' whole (6, 64, 32) and (6, 32, 64); the tuning's quarter of ff
    assert weights == {(6, 64, 32), (6, 32, 64), (6, 64, 8), (6, 8, 64)}


@pytest.mark.parametrize("case", ["4x1_g1", "2x2_g1", "2x2_g2"])
def test_kept_assignments_equal_one_process(ranks, case):
    """Every MoE kept and dropped assignment equals one process's (the
    capacity factor at 1.0, so that some drop)."""
    rec = ranks[0]["kept"][case]
    assert rec["equal"] and 0 < rec["dropped"] < rec["n"]
    assert rec["out"] < 1e-5
    np.testing.assert_allclose(*rec["aux"], rtol=1e-5)


@pytest.mark.parametrize("split", ["experts", "columns", "rows"])
def test_batched_masked_matmul_on_dtensor_slabs(ranks, split):
    assert ranks[0]["batched_dtensor"][split] < 1e-5


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["train", "ebft", "train_f32"])
def test_step_cells_on_2x2_match_one_process(ranks, arch, kind):
    for r in ranks:
        rec = r["cells"][arch][kind]
        assert rec == ranks[0]["cells"][arch][kind]
        np.testing.assert_allclose(*rec["loss"], rtol=2e-3 if kind != "train_f32" else 1e-5)
        if kind != "ebft":
            np.testing.assert_allclose(*rec["grad_norm"], rtol=2e-3)
        assert rec["weights"] <= 2.0 ** -9, rec["weights"]
        limit = {"train": BF16_TRAIN_MOMENTS_REL, "ebft": EBFT_MOMENTS_REL,
                 "train_f32": TRAIN_MOMENTS_REL}[kind]
        assert rec["moments"] <= limit, rec["moments"]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("numerics", ["bf16", "f32"])
def test_prefill_and_decode_cells_on_2x2_match_one_process(ranks, arch, numerics):
    """Each step's logits within 3e-2 of one process's in bf16 (6e-2 for
    the MoE, whose routing flips near ties) and 1e-4 in f32, the same
    greedy tokens where its top two are clear; the Mamba states laid out
    for the head-parallel mixer (``port_cache_pspecs``): the SSM state's
    batch over "data" and heads over "model", the conv state's batch only."""
    rec = ranks[0]["cells"][arch]["serve" if numerics == "bf16" else "serve_f32"]
    assert all(r["cells"][arch] == ranks[0]["cells"][arch] for r in ranks)
    assert rec["plain"] and rec["len"] == 32 + 4
    limit = 1e-4 if numerics == "f32" else 6e-2 if arch == "tiny_moe" else 3e-2
    assert rec["logits"] <= limit and rec["clear"] >= 5 and rec["tokens"], rec
    st = rec["states"]
    if arch == "tiny_ssm":  # (L, B, H, N, P), (L, B, K-1, ch): H 8, ch 128 + 32
        assert st["ssm"] == [[2, 4, 4, 16, 16], ["S1", "S2"]]
        assert st["conv"] == [[2, 4, 3, 160], ["S1", "R"]]
    if arch == "tiny_hybrid":
        assert st["groups/ssm"] == [[2, 2, 4, 4, 16, 16], ["S2", "S3"]]
        assert st["groups/conv"] == [[2, 2, 4, 3, 160], ["S2", "R"]]
        assert st["shared_kv/k"][1] == ["S1", "S2"]
    if arch == "tiny_moe":
        assert st["moe/k"][1] == ["S1", "S2"]


def test_launch_train_on_2x2_matches_one_process(ranks):
    got, one = ranks[0]["launch"], ranks[0]["launch_one"]
    assert [s for s, _ in got["history"]] == [s for s, _ in one["history"]] == [0, 1]
    np.testing.assert_allclose([l for _, l in got["history"]], [l for _, l in one["history"]],
                               rtol=2e-3, atol=1e-5)
    assert all(r["launch"] == got for r in ranks)
    assert one["moments"] <= TRAIN_MOMENTS_REL, one["moments"]  # f32: AdamW's moments
    np.testing.assert_allclose([got["sums"][k] for k in one["sums"]], list(one["sums"].values()),
                               rtol=2e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# in this process: the local rules against their whole-tensor counterparts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunks", [2, 4])
def test_scanned_routing_over_token_chunks_equals_the_reference(chunks):
    """One dispatch group's tokens cut into ``chunks`` pieces, as the data
    ranks hold them: each piece's slot positions from the exclusive scan of
    the pieces before it (``moe.routed_local``'s offsets) keep exactly the
    reference's ``_dispatch_group`` assignments, and the pieces' outputs
    are its output's rows (rtol 1e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import moe as RM
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    cfg = get_config("tiny_moe").replace(moe_capacity_factor=1.0)
    rcfg = ref_get_config("tiny_moe").replace(moe_capacity_factor=1.0)
    E, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    rng = np.random.default_rng(chunks)
    xf = rng.normal(size=(64, d)).astype(np.float32)
    p = {"router": {"w": rng.normal(size=(d, E)).astype(np.float32)},
         "experts": {"w_gate": rng.normal(size=(E, d, 32)).astype(np.float32) * 0.1,
                     "w_up": rng.normal(size=(E, d, 32)).astype(np.float32) * 0.1,
                     "w_down": rng.normal(size=(E, 32, d)).astype(np.float32) * 0.1}}
    ref_out, ref_aux = RM._dispatch_group(jax.tree.map(jnp.asarray, p), jnp.asarray(xf), rcfg)
    _, ridx, _ = RM.route(jnp.asarray(p["router"]["w"]), jnp.asarray(xf), k)
    flat = jnp.asarray(ridx).reshape(-1)
    rpos = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(flat, E, dtype=jnp.int32), 0) - 1,
                               flat[:, None], axis=1)[:, 0]
    C = max(1, int(rcfg.moe_capacity_factor * 64 * k / E))
    ref_keep = np.asarray(rpos < C)
    assert 0 < (~ref_keep).sum()

    tp = interop.params_to_torch(p, "cpu")
    pieces = torch.as_tensor(xf).reshape(chunks, -1, d)
    counts = torch.stack([MOE.expert_counts(MOE.route(tp["router"]["w"], c, k)[1], E)
                          for c in pieces])
    keep, outs, aux = [], [], 0.0
    for j, c in enumerate(pieces):
        offset = counts[:j].sum(0)
        idx = MOE.route(tp["router"]["w"], c, k)[1].reshape(-1)
        keep.append(MOE.scan_positions(idx, E, C, offset)[1])
        o, a = MOE.routed_local(c[None], tp["router"]["w"], tp["experts"], None, cfg, chunk=j,
                                n_chunks=chunks, gather=lambda _: counts)
        outs.append(o[0])
        aux += float(a)
    np.testing.assert_array_equal(torch.cat(keep).numpy(), ref_keep)
    np.testing.assert_allclose(torch.cat(outs).numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, float(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("stateful", [False, True])
def test_mixer_on_head_slices_equals_the_whole_mixer(m, stateful):
    """``ssm.mixer_local`` over H / m head slices (the conv's and the
    per-head vectors' slices taken inside, the gated norm's sums of
    squares added across the slices by hand, the new conv state's x
    channels gathered) equals ``mixer`` over every head: a prompt of 40
    from zero state or from a carried one, then a decode step (f32, within
    1e-5)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import build

    cfg = get_config("tiny_ssm")
    H, P, N, K = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    bp = T.tree_map(torch.clone, build(cfg).get_block(
        build(cfg).init(torch.Generator().manual_seed(0)), 0))
    g = torch.Generator().manual_seed(1)
    bp["dt_bias"] = torch.randn(H, generator=g) * 0.5
    bp["D"] = torch.randn(H, generator=g)
    bp["gnorm"]["w"] = 1 + 0.1 * torch.randn(H * P, generator=g)
    B, S, Hl = 2, 40, H // m
    z, x = (torch.randn(B, S, H, P, generator=g) for _ in range(2))
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    dt_raw = torch.randn(B, S, H, generator=g)
    state = None
    if stateful:
        state = {"conv": torch.randn(B, K - 1, H * P + 2 * N, generator=g),
                 "ssm": torch.randn(B, H, N, P, generator=g)}
    whole, whole_state = SSM.mixer(bp, cfg, z, x, Bm, Cm, dt_raw, state)

    def sliced(z, x, dt_raw, state, s):
        hs = slice(s * Hl, (s + 1) * Hl)
        st = None if state is None else {"conv": state["conv"], "ssm": state["ssm"][:, hs]}
        return z[:, :, hs], x[:, :, hs], dt_raw[:, :, hs], st, bp["gnorm"]["w"][hs.start * P:
                                                                                 hs.stop * P]

    def run(z, x, Bm, Cm, dt_raw, state):
        squares, convs = [], []
        def pass_(sum_sq, gather_x):
            outs = []
            for s in range(m):
                zs, xs, ds, st, gw = sliced(z, x, dt_raw, state, s)
                outs.append(SSM.mixer_local(
                    cfg, zs, xs, Bm, Cm, ds, bp["conv_w"], bp["conv_b"], bp["A_log"], bp["D"],
                    bp["dt_bias"], gw, st, h0=s * Hl, sum_sq=sum_sq, gather_x=gather_x))
            return outs
        pass_(lambda t: squares.append(t) or t, lambda t: convs.append(t) or t)
        total, conv_x = sum(squares), torch.cat(convs, dim=-1) if convs else None
        outs = pass_(lambda t: total, lambda t: conv_x)
        y = torch.cat([o[0] for o in outs], dim=-1)
        if state is None:
            return y, None
        return y, {"conv": outs[0][1]["conv"], "ssm": torch.cat([o[1]["ssm"] for o in outs], 1)}

    y, new_state = run(z, x, Bm, Cm, dt_raw, state)
    np.testing.assert_allclose(y.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    if stateful:
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(new_state[key].numpy(), whole_state[key].numpy(),
                                       rtol=1e-5, atol=1e-5)
        step = [t[:, :1] for t in (z, x, Bm, Cm, dt_raw)]
        y1, s1 = run(*step, new_state)
        w1, ws1 = SSM.mixer(bp, cfg, *step, whole_state)
        np.testing.assert_allclose(y1.numpy(), w1.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s1["ssm"].numpy(), ws1["ssm"].numpy(), rtol=1e-5, atol=1e-5)


def test_narrow_column_shard_is_padded_for_the_bf16_kernel():
    """Mamba2-130M's ``in_dt`` (768, 24) is (768, 12) a rank on 1 × 2, a
    width the bf16 kernel does not take (N a multiple of 8). The local
    route pads the weight and the mask with zero columns to 16, masked out,
    so the cut product is the unpadded one; the mask keeps 16-byte rows."""
    from repro_torch.distributed.local_kernels import pad_columns
    from repro_torch.kernels.masked_matmul import ops as MM

    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 768, generator=g)
    w = torch.randn(768, 12, generator=g)
    m = torch.rand(768, 12, generator=g) < 0.5
    wp, mp = pad_columns(w, m, 8)
    assert wp.shape == mp.shape == (768, 16) and mp.stride(0) == 16
    assert not mp[:, 12:].any() and not wp[:, 12:].any()
    torch.testing.assert_close(MM.masked_matmul(x, wp, mp)[:, :12], MM.masked_matmul(x, w, m),
                               rtol=0, atol=0)
    w4, m4 = pad_columns(w[:, :4], m[:, :4], 8)  # a mask row of 8 bytes sits in 16
    assert m4.shape == (768, 8) and m4.stride(0) == 16
