"""The sharded prefill, decode and ebft cells (``launch/steps.py``): four
gloo ranks on the CPU, against one device.

One module-scoped fixture starts four processes once (a file store, one
thread each), as ``tests/test_torch_mesh_ebft.py`` does. On a 2 × 2 mesh
they run tiny_dense at 2 layers (bf16):

* the prefill cell on 8 prompts of 32 tokens, then 4 greedy decode cells
  (a cache of depth 36 placed by ``port_cache_pspecs``: the batch over
  "data", the KV heads over "model"), fed one device's greedy tokens, each
  step's logits and greedy tokens against the same cells on one device;
* the ebft cell (block 1, lr 2e-4, batch 8 × 32) in the tensor-parallel
  and the ``dp_only`` layouts, its loss and updated block against one
  device; a spy on Adam records each gradient's placements, which must be
  its moment's (ZeRO-2: the data-sharded layout);
* a cell of the VLM or the encoder-decoder on an active mesh, which must
  raise, citing ROADMAP.md A.8e (the MoE, SSM and hybrid cells run:
  ``tests/test_torch_mesh_families.py``);
* the host-staged collectives (``distributed.host_collectives``) on CPU
  tensors against gloo's own;
* global-norm clipping and top-k compression with error feedback of
  DTensor gradients against one device's.

Stated tolerances (bf16): logits within 3e-2 of one device's, the greedy
tokens equal wherever one device's top-two gap exceeds 6e-2; the ebft
loss within rtol 2e-3, the updated block within 2^-9, and Adam's moments
(m = 0.1 g: the gradient itself) within 3e-2 in relative L2 a leaf
(measured 7.1e-3 and 8.7e-3; a gradient left unsummed over the data
ranks reads 0.94–0.95, where the weights and the loss still pass).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

WORLD = 4
MOMENTS_REL = 3e-2  # the ebft cell's Adam moments, relative L2 a leaf

RANK_SCRIPT = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                        rank=rank, world_size=world)
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import host_collectives as HC
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_abstract_mesh, make_debug_mesh
from repro_torch.optim import optimizers as O

ONE = make_abstract_mesh((1, 1), ("data", "model"))
def names(placements):
    return [f"S{p.dim}" if p.is_shard() else "P" if p.is_partial() else "R" for p in placements]
mesh = make_debug_mesh(2, 2, "cpu")
cfg = get_config("tiny_dense").replace(num_layers=2)
B, P, N = 8, 32, 4
rng = np.random.default_rng(0)
prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32))
out = {}

def greedy(m, forced=None):
    pc = ST.build_prefill_cell(cfg, ShapeConfig("p", P, B, "prefill"), m)
    dc = ST.build_decode_cell(cfg, ShapeConfig("d", P + N - 1, B, "decode"), m)
    params = pc.model.init(torch.Generator().manual_seed(0))
    state = pc.model.init_serve_state(B, P + N, "cpu")
    logits, state = ST.run_cell(pc, m, params, {"tokens": prompts}, state)
    steps, local, toks = [logits[:, -1]], None, []
    for i in range(N):  # the mesh is fed one device's tokens: a near tie may pick otherwise
        tok = steps[-1].argmax(-1)[:, None].to(torch.int32) if forced is None else forced[i]
        toks.append(tok)
        logits, state = ST.run_cell(dc, m, params, tok, state)
        steps.append(logits[:, -1])
        if local is None and hasattr(state["k"], "to_local"):
            local = [list(state["k"].to_local().shape), names(state["k"].placements)]
    return [s.float().tolist() for s in steps], state["len"], local, \
        all(type(s) is torch.Tensor for s in steps), toks

one = greedy(ONE)
mesh_run = greedy(mesh, forced=one[4])
out["serve"] = {"one": one[0], "mesh": mesh_run[0], "len": mesh_run[1],
                "local_k": mesh_run[2], "plain_logits": mesh_run[3]}

grads_seen = []
adam = O.adam
def spy_adam(lr):
    opt = adam(lr)
    def update(grads, state, params=None):
        moments = dict(T.leaves_with_path(state["m"]))
        for path, g in T.leaves_with_path(grads):
            if hasattr(g, "placements"):  # the mesh's run
                grads_seen.append(("/".join(path), names(g.placements),
                                   names(moments[path].placements)))
        return opt.update(grads, state, params)
    return type(opt)(opt.init, update)
O.adam = spy_adam

def ebft(m, dp_only):
    cell = ST.build_ebft_cell(cfg, ShapeConfig("e", P, B, "ebft"), m, dp_only=dp_only)
    full = cell.model.init(torch.Generator().manual_seed(1))
    bw = T.tree_map(torch.clone, cell.model.get_block(full, 1))
    g = torch.Generator().manual_seed(2)
    masks = T.tree_map(lambda t: ((torch.rand(t.shape, generator=g) < 0.5) | (t.dim() < 2))
                       .to(torch.bfloat16), bw)
    h, tgt = (torch.randn(B, P, cfg.d_model, generator=g).to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(P, dtype=torch.int32)[None]
    nbw, opt_state, loss = ST.run_cell(cell, m, bw, O.adam(2e-4).init(bw), masks, h, tgt, pos)
    return float(loss), MeshPlan.gather(nbw), MeshPlan.gather(opt_state)

def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()

for dp_only in (False, True):
    grads_seen.clear()
    loss1, bw1, o1 = ebft(ONE, dp_only)
    grads_seen.clear()
    loss, bw, o = ebft(mesh, dp_only)
    out[f"ebft_{dp_only}"] = {
        "loss": loss, "loss_one": loss1, "grads": list(grads_seen),
        "max_diff": max((t.float() - T.get_path(bw1, p).float()).abs().max().item()
                        for p, t in T.leaves_with_path(bw)),
        # Adam's first moments carry the gradient itself (m = 0.1 g), the
        # second its square: a relative L2 per leaf against one device's
        "moments_rel": {f"{k}/" + "/".join(p): rel_l2(t, T.get_path(o1[k], p))
                        for k in ("m", "v") for p, t in T.leaves_with_path(o[k])}}
O.adam = adam

refused = {}
for arch in ("tiny_vlm", "tiny_encdec"):
    try:
        ST.build_train_cell(get_config(arch), ShapeConfig("t", 32, 8, "train"), mesh)
        refused[arch] = None
    except NotImplementedError as e:
        refused[arch] = str(e)
out["refused"] = refused

# the host-staged collectives give gloo's own results
group = dist.group.WORLD.group_name
x = torch.arange(8, dtype=torch.float32) + rank
F = torch.ops._c10d_functional
staged = {}
for name, args in (("all_reduce", ("sum", group)),
                   ("all_gather_into_tensor", (world, group)),
                   ("reduce_scatter_tensor", ("sum", world, group)),
                   ("all_to_all_single", ([2] * world, [2] * world, group))):
    op = getattr(F, name).default
    staged[name] = torch.equal(HC.staged(op)(x, *args), F.wait_tensor(op(x, *args)))
out["staged"] = staged

# clipping and top-k compression of DTensor gradients give one device's
# numbers (the compressed leaf is gathered whole, as the reference's top-k)
from torch.distributed.tensor import distribute_tensor
from repro_torch.optim import grad_compress as GC
g = torch.Generator().manual_seed(3)
grads = {"a": torch.randn(64, 32, generator=g), "b": torch.randn(16, generator=g)}
specs = {"a": ("data", "model"), "b": (None,)}
dgrads = ST.place(grads, specs, mesh)
clipped, norm = O.clip_by_global_norm(grads, 1.0)
dclipped, dnorm = O.clip_by_global_norm(dgrads, 1.0)
err = GC.init_error_state(grads)
sent, new_err = GC.compress(grads, err, 0.25)
dsent, dnew_err = GC.compress(dgrads, GC.init_error_state(dgrads), 0.25)
whole = MeshPlan.gather
out["clip_compress"] = {
    "norm": [float(norm), float(whole(dnorm))],
    "clipped": max((whole(dclipped[k]) - clipped[k]).abs().max().item() for k in grads),
    "sent": all(torch.equal(whole(dsent[k]), sent[k]) for k in grads),
    "err": all(torch.equal(whole(dnew_err[k]), new_err[k]) for k in grads),
    "placed": [names(dsent["a"].placements), names(dnew_err["a"].placements)]}
with open(os.path.join(os.environ["MESH_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cells")
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               WORLD_SIZE=str(WORLD), MESH_STORE=str(tmp / "store"), MESH_OUT=str(tmp),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=300)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_prefill_and_decode_cells_on_2x2_match_one_device(ranks):
    for r in ranks:
        rec = r["serve"]
        assert rec == ranks[0]["serve"]
        assert rec["len"] == 32 + 4 and rec["plain_logits"]
        # each rank's cache: its 4 rows, its 2 of 4 KV heads, the whole depth
        assert rec["local_k"] == [[2, 4, 2, 36, 16], ["S1", "S2"]]
        one, got = np.array(rec["one"]), np.array(rec["mesh"])
        assert got.shape == one.shape == (5, 8, 512)
        np.testing.assert_allclose(got, one, rtol=0, atol=3e-2)
        top2 = np.sort(one, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 6e-2
        assert clear.sum() >= 10
        np.testing.assert_array_equal(got.argmax(-1)[clear], one.argmax(-1)[clear])


@pytest.mark.parametrize("dp_only", [False, True])
def test_ebft_cell_on_2x2_matches_one_device(ranks, dp_only):
    for r in ranks:
        rec = r[f"ebft_{dp_only}"]
        np.testing.assert_allclose(rec["loss"], rec["loss_one"], rtol=2e-3)
        assert rec["max_diff"] <= 2.0 ** -9, rec["max_diff"]
        assert len(rec["moments_rel"]) == 18
        worst = max(rec["moments_rel"].items(), key=lambda kv: kv[1])
        assert worst[1] <= MOMENTS_REL, worst
        assert rec == ranks[0][f"ebft_{dp_only}"]


@pytest.mark.parametrize("dp_only", [False, True])
def test_ebft_gradients_reach_adam_in_the_moments_layout(ranks, dp_only):
    """ZeRO-2: every gradient reaches Adam in its moment's placements, no
    ``Partial`` left, and the large leaves data-sharded."""
    grads = ranks[0][f"ebft_{dp_only}"]["grads"]
    assert len(grads) == 9
    for name, g, m in grads:
        assert g == m and "P" not in g, (name, g, m)
    assert sum(g[0].startswith("S") for _, g, _ in grads) >= 7


def test_other_families_refuse_an_active_mesh(ranks):
    assert set(ranks[0]["refused"]) == {"tiny_vlm", "tiny_encdec"}
    for arch, msg in ranks[0]["refused"].items():
        assert msg is not None and "A.8e" in msg, arch


def test_host_staged_collectives_match_gloo(ranks):
    for r in ranks:
        assert r["staged"] == {"all_reduce": True, "all_gather_into_tensor": True,
                               "reduce_scatter_tensor": True, "all_to_all_single": True}


def test_clipping_and_compression_of_dtensor_gradients_match_one_device(ranks):
    for r in ranks:
        rec = r["clip_compress"]
        np.testing.assert_allclose(*rec["norm"], rtol=1e-6)
        assert rec["clipped"] <= 1e-6
        assert rec["sent"] and rec["err"]  # the whole leaf's top k, put back in place
        assert rec["placed"] == [["S0", "S1"], ["S0", "S1"]]
