"""Round trips of params and masks between the JAX reference's trees and
the port's tensors."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro.models.model import build as ref_build
from repro.sparsity import sparse_params as RSP
from repro_torch import interop
from repro_torch import tree as T


@pytest.fixture(scope="module")
def ref_params():
    return ref_build(ref_get_config("tiny_dense")).init(jax.random.PRNGKey(5))


def _flat_ref(tree):
    return {tuple(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip(ref_params, dtype):
    src = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), ref_params)
    port = interop.params_to_torch(src, "cpu")
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ref_flat = _flat_ref(src)
    assert {p for p, _ in T.leaves_with_path(port)} == set(ref_flat)
    for path, t in T.leaves_with_path(port):
        assert t.dtype == want_dtype and tuple(t.shape) == ref_flat[path].shape, path
    back = interop.params_to_numpy(port)
    for path, a in T.leaves_with_path(back):
        np.testing.assert_array_equal(a, ref_flat[path].astype(np.float32))
    # stacked leaves keep their L axis and the (L, d, H, hd) layout
    L = ref_get_config("tiny_dense").num_layers
    assert port["blocks"]["attn"]["wq"].shape[0] == L
    assert port["blocks"]["attn"]["wq"].dim() == 4


def test_masks_round_trip(ref_params):
    cfg = ref_get_config("tiny_dense")
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size))
    masks, _ = ref_prune(ref_build(cfg), ref_params, calibration_set(corpus, 8, 32),
                         method="wanda", sparsity=0.5)
    port = interop.masks_to_torch(jax.tree.map(np.asarray, masks), "cpu")
    ref_flat = _flat_ref(masks)
    for path, m in T.leaves_with_path(port):
        assert m.dtype == torch.bool
        np.testing.assert_array_equal(m.numpy(), ref_flat[path] != 0)
    back = interop.masks_to_numpy(port)

    def check(path, p):
        names = RSP._path_names(path)
        b = T.get_path(back, names)
        assert b.dtype == np.float32
        if RSP.is_prunable(path, p):
            np.testing.assert_array_equal(b, ref_flat[names])
        else:
            assert b.shape == () and float(b) == 1.0  # as the reference's ones_masks
        return p

    jax.tree_util.tree_map_with_path(check, ref_params)
    # and the reference takes them back as masks
    RSP.apply_masks(ref_params, jax.tree.map(jnp.asarray, back))


def test_scalar_masks_stay_scalar():
    port = interop.masks_to_torch({"a": np.float32(1.0), "b": np.zeros((2, 2), np.float32)},
                                  "cpu")
    assert port["a"].shape == () and bool(port["a"])
    assert port["b"].shape == (2, 2) and not bool(port["b"].any())


@pytest.mark.parametrize("to_torch", [interop.params_to_torch, interop.masks_to_torch])
def test_loaders_default_to_the_card(to_torch):
    """Left without a device, the loaders put the trees on the card, and
    with no card they raise rather than load onto the CPU."""
    tree = {"w": np.ones((2, 2), np.float32)}
    if torch.cuda.is_available():
        assert to_torch(tree)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            to_torch(tree)
