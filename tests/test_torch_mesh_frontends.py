"""The VLM and the encoder-decoder on a device mesh: the EBFT walk, the four
cells of ``launch/steps.py`` and ``launch/train``, four gloo ranks on the
CPU against one process of the port.

One module-scoped fixture starts four processes once (a file store, one
thread each), as ``tests/test_torch_mesh_families.py`` does. They run:

* the walk (magnitude 0.5, 2 epochs, microbatch 8, 16 segments: tiny_vlm
  [8 seeded patches ; 24 tokens], tiny_encdec 24 tokens over 8 seeded
  frames, lr 1e-2) on 4 × 1 and 2 × 2, against one process; a spy on the
  decoder blocks records the memory's placements and local shape, and one
  on the attention its local calls (causal or not, Sq, Sk, local heads);
* the train, ebft, prefill and decode cells of each on 2 × 2 (bf16; the
  train and serving cells again in f32), their batches holding the
  patches or frames (``Model.input_specs``), against the same cell's
  function on plain tensors; the encoder-decoder's ebft cell tunes an
  encoder block, its serve state keeps the memory as the reference's
  ``cache_pspecs`` lays it out;
* ``launch/train.run`` of each on 2 × 2 for 2 steps with the patches or
  frames it draws, against one process.

Stated tolerances, ``tests/test_torch_mesh_families.py``'s: the walks'
histories within rtol 2e-3, atol 1e-5 of one process's, with the same
``epochs_run`` and ``early_stop``; the cells' losses within rtol 2e-3
(1e-5 in f32), updated weights within 2^-9, Adam's moments within 3e-2
(ebft) and AdamW's within 0.25 (bf16 train) or 5e-2 (f32) in relative L2
a leaf, logits within 3e-2 (bf16) and 1e-4 (f32) with the same greedy
tokens where one process's top two are clear; ``launch/train``'s losses
within rtol 2e-3, atol 1e-5.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

WORLD = 4
ARCHS = ("tiny_vlm", "tiny_encdec")
WALKS = [(a, d, m) for a in ARCHS for d, m in ((4, 1), (2, 2))]
EBFT_MOMENTS_REL = 3e-2
TRAIN_MOMENTS_REL = 5e-2
BF16_TRAIN_MOMENTS_REL = 0.25

RANK_SCRIPT = r"""
import dataclasses, json, os
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
from repro_torch.core import ebft
from repro_torch.core.masks import prune
from repro_torch.distributed.local_kernels import any_dtensor
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh, make_ebft_plan
from repro_torch.models import layers as L
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adam, adamw

N, TEXT, FRONT = 16, 24, 8
out = {"walks": {}, "one": {}}

def names(placements):
    return [f"S{p.dim}" if p.is_shard() else "P" if p.is_partial() else "R" for p in placements]

def front(cfg, n):
    key = "patches" if cfg.family == "vlm" else "frames"
    return {key: np.random.default_rng(7).normal(size=(n, FRONT, cfg.d_model)).astype(np.float32)}

attend = L.attend
seen_attn = set()
def attend_spy(q, k, v, **kw):
    if not any_dtensor(q, k, v):  # a rank's local call
        seen_attn.add((kw["causal"], q.shape[1], k.shape[1], q.shape[2]))
    return attend(q, k, v, **kw)
L.attend = attend_spy

def walk(name, plan):
    cfg = get_config(name)
    model = build(cfg)
    memory = []
    apply = model.apply_block
    def spy(params, i, bp, h, positions, masks=None, **aux):
        m = aux.get("memory")
        if m is not None and any_dtensor(m):
            memory.append((names(m.placements), list(m.to_local().shape)))
        return apply(params, i, bp, h, positions, masks, **aux)
    model = dataclasses.replace(model, apply_block=spy)
    params = model.init(torch.Generator().manual_seed(0))
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(N, TEXT)).astype(np.int32)
    eb = front(cfg, N)
    masks, pruned = prune(model, params, calib, method="magnitude", sparsity=0.5, extra_batch=eb)
    seen_attn.clear()
    tuned, reps = ebft.finetune(model, params, pruned, masks, calib,
                                ebft.EBFTConfig(lr=1e-2, epochs=2, microbatch=8, mesh_plan=plan),
                                extra_batch=eb)
    return {"reports": [r.asdict() for r in reps],
            "tuned": {"/".join(p): t.double().sum().item() for p, t in T.leaves_with_path(tuned)},
            "plain": all(type(t) is torch.Tensor for t in T.tensors(tuned)),
            "memory": sorted({json.dumps(m) for m in memory}),
            "attention": sorted(seen_attn)}

for name, d, m in json.loads(os.environ["WALKS"]):
    if rank == 0 and name not in out["one"]:
        out["one"][name] = walk(name, None)
    out["walks"][f"{name}_{d}x{m}"] = walk(name, make_ebft_plan(d, m, device_type="cpu"))
L.attend = attend

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
def batch_for(model, shape, seed):
    g = torch.Generator().manual_seed(seed)
    b = {}
    for k, sp in model.input_specs(shape).items():
        b[k] = (torch.randint(0, model.cfg.vocab_size, sp.shape, generator=g, dtype=torch.int32)
                if k == "tokens" else torch.randn(sp.shape, generator=g).to(sp.dtype))
    return b

def train_cell(cfg):
    shape = ShapeConfig("t", P, B, "train")
    cell = ST.build_train_cell(cfg, shape, mesh, lr=1e-4)
    params = cell.model.init(torch.Generator().manual_seed(0))
    opt = adamw(1e-4).init(params)
    batch = batch_for(cell.model, shape, 1)
    p1, o1, m1 = cell.fn(clone(params), clone(opt), clone(batch))
    p, o, m = ST.run_cell(cell, mesh, params, opt, batch)
    return {"loss": [float(m["loss"]), float(m1["loss"])],
            "grad_norm": [float(m["grad_norm"]), float(m1["grad_norm"])],
            "batch": sorted(batch), "weights": state_diff(MeshPlan.gather(p), p1),
            "moments": moments_rel(MeshPlan.gather(o), o1)}

def ebft_cell(cfg):
    cell = ST.build_ebft_cell(cfg, ShapeConfig("e", P, B, "ebft"), mesh)
    i = cfg.enc_layers // 2 if cfg.family == "encdec" else cell.model.num_blocks // 2
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
    return {"block": i, "kind": "xattn" in bw and "dec" or "enc_or_dense",
            "loss": [float(l), float(l1)], "weights": state_diff(MeshPlan.gather(nb), nb1),
            "moments": moments_rel(MeshPlan.gather(os_), os1)}

def serve_cells(cfg):  # prefill, then greedy decode fed one process's tokens
    shape = ShapeConfig("p", P, B, "prefill")
    pc = ST.build_prefill_cell(cfg, shape, mesh)
    dc = ST.build_decode_cell(cfg, ShapeConfig("d", P + NDEC - 1, B, "decode"), mesh)
    sp = pc.model.init(torch.Generator().manual_seed(3))
    batch = batch_for(pc.model, shape, 4)
    def serve(run, feed=None):
        state = pc.model.init_serve_state(B, P + NDEC, "cpu")
        logits, state = run(pc, sp, clone(batch), state)
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
    cache = state.get("cache", state)
    return {"logits": (got - one).abs().max().item(), "len": cache["len"],
            "plain": type(got) is torch.Tensor, "clear": int(clear.sum()),
            "tokens": bool((got.argmax(-1)[clear] == one.argmax(-1)[clear]).all()),
            "states": {"/".join(p_): [list(t.to_local().shape), names(t.placements)]
                       for p_, t in T.leaves_with_path(state) if hasattr(t, "to_local")}}

cells = {}
adapt = ST.adapt_config
for name in json.loads(os.environ["ARCHS"]):
    cfg = get_config(name)
    cells[name] = {"train": train_cell(cfg), "ebft": ebft_cell(cfg), "serve": serve_cells(cfg)}
    ST.adapt_config = lambda *a, **k: adapt(*a, **k).replace(dtype="float32",
                                                             param_dtype="float32")
    cells[name]["train_f32"] = train_cell(cfg)
    cells[name]["serve_f32"] = serve_cells(cfg)
    ST.adapt_config = adapt
out["cells"] = cells

out["launch"], out["launch_one"] = {}, {}
for name in json.loads(os.environ["ARCHS"]):
    spec = train.TrainSpec(arch=name, steps=2, batch=8, seq=32)
    res = train.run(get_config(name), spec, "cpu", say=lambda *a: None, mesh=mesh, log_every=1)
    out["launch"][name] = {"history": res.history,
                           "placed": names(next(iter(T.tensors(res.params))).placements)}
    launch_opt = MeshPlan.gather(res.opt_state)  # a collective: every rank
    if rank == 0:
        one = train.run(get_config(name), spec, "cpu", say=lambda *a: None, log_every=1)
        out["launch_one"][name] = {"history": one.history,
                                   "moments": moments_rel(launch_opt, one.opt_state)}
with open(os.path.join(os.environ["MESH_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, by rank."""
    tmp = tmp_path_factory.mktemp("mesh_frontends")
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               WORLD_SIZE=str(WORLD), MESH_STORE=str(tmp / "store"), MESH_OUT=str(tmp),
               WALKS=json.dumps(WALKS), ARCHS=json.dumps(ARCHS), OMP_NUM_THREADS="1")
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


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_the_memory_is_placed_on_the_data_axes_with_its_microbatch(ranks, mesh):
    """Every decoder visit (teacher, student and tuning) reads the memory
    (8 rows a microbatch, 8 frames, d 64) sharded on its batch dim over
    "data" and whole over "model": a rank's rows are its microbatch rows."""
    data = int(mesh.split("x")[0])
    for r in ranks:
        got = [json.loads(m) for m in r["walks"][f"tiny_encdec_{mesh}"]["memory"]]
        assert got == [[["S0", "R"], [8 // data, 8, 64]]]
    assert ranks[0]["one"]["tiny_encdec"]["memory"] == []  # one process: plain tensors


def test_attention_runs_on_local_heads_and_rows(ranks):
    """On 2 × 2 (4 heads, microbatch 8) the tuned block's attention runs on
    2 heads a rank, and the streams' on 4 rows a rank: the encoder's
    bidirectional self-attention over the 8 frames, the decoder's causal
    self-attention over 24 tokens, and its cross-attention (24 queries over
    8 frames, not causal); the VLM's causal attention over [8 patches ; 24
    tokens]."""
    enc = {tuple(a) for a in ranks[0]["walks"]["tiny_encdec_2x2"]["attention"]}
    assert {(False, 8, 8, 2), (True, 24, 24, 2), (False, 24, 8, 2)} <= enc
    assert all(h in (2, 4) for *_, h in enc)
    vlm = {tuple(a) for a in ranks[0]["walks"]["tiny_vlm_2x2"]["attention"]}
    assert (True, 32, 32, 2) in vlm and all(c and s == 32 for c, s, _, _ in vlm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "ebft", "train_f32"])
def test_step_cells_on_2x2_match_one_process(ranks, arch, kind):
    for r in ranks:
        rec = r["cells"][arch][kind]
        assert rec == ranks[0]["cells"][arch][kind]
        np.testing.assert_allclose(*rec["loss"], rtol=2e-3 if kind != "train_f32" else 1e-5)
        if kind != "ebft":
            np.testing.assert_allclose(*rec["grad_norm"], rtol=2e-3)
            assert rec["batch"] == sorted(["tokens", "patches" if arch == "tiny_vlm" else "frames"])
        else:  # the encoder-decoder tunes encoder block enc_layers // 2 = 1
            assert rec["block"] == 1 and rec["kind"] == "enc_or_dense"
        assert rec["weights"] <= 2.0 ** -9, rec["weights"]
        limit = {"train": BF16_TRAIN_MOMENTS_REL, "ebft": EBFT_MOMENTS_REL,
                 "train_f32": TRAIN_MOMENTS_REL}[kind]
        assert rec["moments"] <= limit, rec["moments"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("numerics", ["bf16", "f32"])
def test_prefill_and_decode_cells_on_2x2_match_one_process(ranks, arch, numerics):
    """Each step's logits within 3e-2 of one process's in bf16 and 1e-4 in
    f32, the same greedy tokens where its top two are more than 6e-2 apart
    (at least 4 of the 5 steps' 8 rows: the seeded init's logits are
    flat). The caches'
    batch over "data" and KV heads over "model"; the encoder-decoder's
    memory (8, F 4, d 64) as the reference's ``cache_pspecs`` lays it out,
    F over "data" and d over "model"."""
    rec = ranks[0]["cells"][arch]["serve" if numerics == "bf16" else "serve_f32"]
    assert all(r["cells"][arch] == ranks[0]["cells"][arch] for r in ranks)
    assert rec["plain"] and rec["len"] == 32 + 4
    limit = 1e-4 if numerics == "f32" else 3e-2
    assert rec["logits"] <= limit and rec["clear"] >= 4 and rec["tokens"], rec
    st = rec["states"]
    if arch == "tiny_encdec":
        assert st["memory"] == [[8, 2, 32], ["S1", "S2"]]
        assert st["cache/k"][1] == ["S1", "S2"]
    else:
        assert st["k"][1] == ["S1", "S2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_2x2_matches_one_process(ranks, arch):
    got, one = ranks[0]["launch"][arch], ranks[0]["launch_one"][arch]
    assert [s for s, _ in got["history"]] == [s for s, _ in one["history"]] == [0, 1]
    np.testing.assert_allclose([l for _, l in got["history"]], [l for _, l in one["history"]],
                               rtol=2e-3, atol=1e-5)
    assert all(r["launch"][arch] == got for r in ranks)
    assert one["moments"] <= TRAIN_MOMENTS_REL, one["moments"]
