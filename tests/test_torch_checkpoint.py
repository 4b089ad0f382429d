"""The port's checkpoints (``repro_torch.checkpoint.ckpt``): the
reference's checkpoint tests mirrored, and checkpoints written by either
package restored by the other, bit for bit (f32, bf16 and the int32
step)."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro_torch.checkpoint import ckpt as CK


@pytest.fixture()
def tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": torch.tensor(rng.normal(size=(8, 4)).astype(np.float32)),
                   "b": torch.tensor(rng.normal(size=(4,)).astype(np.float32))},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return [t for _, t in CK._flatten(tree)]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path, tree):
    CK.save(str(tmp_path), tree, step=3, async_write=False)
    out = CK.restore(str(tmp_path), tree)
    assert all(_same_bits(a, b) for a, b in zip(_leaves(tree), _leaves(out)))
    assert list(out) == list(tree) and list(out["params"]) == ["w", "b"]


def test_latest_step_and_multiple(tmp_path, tree):
    for s in (1, 5, 3):
        CK.save(str(tmp_path), tree, step=s, async_write=False)
    assert CK.latest_step(str(tmp_path)) == 5
    assert CK.restore(str(tmp_path), tree, step=3) is not None


def test_restore_without_checkpoint_raises(tmp_path, tree):
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), tree)


def test_async_write_visible_after_wait(tmp_path, tree):
    CK.save(str(tmp_path), tree, step=9, async_write=True)
    CK.wait_all()
    assert CK.latest_step(str(tmp_path)) == 9


def test_async_write_snapshots_before_returning(tmp_path, tree):
    """The train step writes the weights in place: what an async save
    writes is the tree as it was when ``save`` returned."""
    want = tree["params"]["w"].clone()
    CK.save(str(tmp_path), tree, step=1, async_write=True)
    tree["params"]["w"].add_(1.0)
    CK.wait_all()
    assert torch.equal(CK.restore(str(tmp_path), tree)["params"]["w"], want)


def test_async_write_error_surfaces_in_wait_all(tmp_path, tree):
    target = tmp_path / "not_a_dir"
    target.write_text("a file where the checkpoint directory should be")
    CK.save(str(target), tree, step=1, async_write=True)
    with pytest.raises(OSError):
        CK.wait_all()


def test_crashed_tmp_dir_is_ignored_and_cleaned(tmp_path, tree):
    """A stale .tmp (a crash mid-write) is no checkpoint, and the next save
    of its step removes it."""
    stale = os.path.join(str(tmp_path), "step_00000002.tmp")
    os.makedirs(stale)
    assert CK.latest_step(str(tmp_path)) is None
    CK.save(str(tmp_path), tree, step=2, async_write=False)
    assert not os.path.exists(stale)
    assert CK.latest_step(str(tmp_path)) == 2


def test_template_drift_is_caught(tmp_path, tree):
    CK.save(str(tmp_path), tree, step=1, async_write=False)
    with pytest.raises(AssertionError, match="config drift"):
        CK.restore(str(tmp_path), {"params": {"w": tree["params"]["w"]}})


def test_restore_casts_to_template_dtype(tmp_path, tree):
    CK.save(str(tmp_path), tree, step=1, async_write=False)
    cast = {"params": {k: v.to(torch.bfloat16) for k, v in tree["params"].items()},
            "opt": tree["opt"]}
    out = CK.restore(str(tmp_path), cast)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], tree["params"]["w"].to(torch.bfloat16))
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 7


def test_bf16_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    t = {"w": torch.tensor(rng.normal(size=(16, 8)).astype(np.float32)).to(torch.bfloat16)}
    CK.save(str(tmp_path), t, step=1, async_write=False)
    out = CK.restore(str(tmp_path), t)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), t["w"].view(torch.int16))


def test_none_subtree_has_no_leaf(tmp_path):
    """SGD without momentum keeps ``mu = None``: no leaf, as in jax."""
    t = {"step": torch.tensor(3, dtype=torch.int32), "mu": None}
    CK.save(str(tmp_path), t, step=1, async_write=False)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["names"] == ["step"]
    out = CK.restore(str(tmp_path), t)
    assert out["mu"] is None and int(out["step"]) == 3


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _mixed(rng):
    """bf16 and f32 leaves and an int32 step, in an order that is not
    sorted (``repro_torch.tree`` walks insertion order, jax sorts)."""
    w = rng.normal(size=(6, 5)).astype(np.float32)
    return {"params": {"wq": w, "b": rng.normal(size=(5,)).astype(np.float32),
                       "a_emb": rng.normal(size=(3, 4)).astype(np.float32)},
            "opt_state": {"step": np.int32(11), "m": {"x": rng.normal(size=(2,))
                                                      .astype(np.float32)}}}


def _to_torch(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v)
        else:
            t = torch.tensor(np.asarray(v))
            out[k] = t.to(torch.bfloat16) if k == "wq" else t
    return out


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else
            (jnp.asarray(v).astype(jnp.bfloat16) if k == "wq" else jnp.asarray(v))
            for k, v in tree.items()}


def _equal_bits(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return a.dtype.name == "bfloat16" and np.array_equal(
            t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    return str(a.dtype) == str(t.numpy().dtype) and np.array_equal(t.numpy(), a)


def _pairs(ttree, jtree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = CK._flatten(ttree)
    assert ["/".join(str(k.key) for k in p) for p, _ in jl] == ["/".join(p) for p, _ in tl]
    return [(t, a) for (_, t), (_, a) in zip(tl, jl)]


def test_port_restores_what_the_reference_wrote(tmp_path):
    src = _mixed(np.random.default_rng(2))
    RCK.save(str(tmp_path), _to_jax(src), step=4, async_write=False)
    template = _to_torch(_mixed(np.random.default_rng(3)))
    out = CK.restore(str(tmp_path), template)
    pairs = _pairs(out, _to_jax(src))
    assert all(_equal_bits(t, a) for t, a in pairs)
    assert out["params"]["wq"].dtype == torch.bfloat16
    assert out["opt_state"]["step"].dtype == torch.int32


def test_reference_restores_what_the_port_wrote(tmp_path):
    src = _to_torch(_mixed(np.random.default_rng(4)))
    CK.save(str(tmp_path), src, step=5, async_write=True)
    CK.wait_all()
    assert RCK.latest_step(str(tmp_path)) == 5
    out = RCK.restore(str(tmp_path), _to_jax(_mixed(np.random.default_rng(5))))
    pairs = _pairs(src, out)
    assert all(_equal_bits(t, a) for t, a in pairs)
    assert out["params"]["wq"].dtype == jnp.bfloat16
    assert out["opt_state"]["step"].dtype == jnp.int32


def test_manifest_matches_the_reference(tmp_path):
    """The same keys, names, shapes and dtype strings as the reference
    writes for the same tree."""
    src = _mixed(np.random.default_rng(6))
    RCK.save(str(tmp_path / "ref"), _to_jax(src), step=1, async_write=False)
    CK.save(str(tmp_path / "port"), _to_torch(src), step=1, async_write=False)
    ref, port = (json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())
                 for d in ("ref", "port"))
    assert list(port) == list(ref)
    for key in ("step", "mesh_shape", "names", "shapes", "dtypes", "source_specs"):
        assert port[key] == ref[key], key
    with np.load(tmp_path / "ref" / "step_00000001" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
