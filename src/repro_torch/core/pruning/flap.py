"""FLAP (An et al. 2023): fluctuation-based adaptive structured pruning
(port of ``repro.core.pruning.flap``).

The structured units are attention heads and MLP hidden channels. A
unit's importance is the fluctuation of its input feature around the
calibration mean, weighted by the squared norm of the weights that read it:

    head h:     sum_{j in h} fluct(X_j) * ||W_o[j, :]||^2
    channel j:  fluct(X_j) * ||W_down[j, :]||^2

Scores are standardised per block and kind (the population std, as
``jnp.std``), one global threshold picks the units that stay (every unit
tied at the threshold stays), and a block that would lose every head or
every channel keeps its best one. Masks stay elementwise, broadcast from
the unit masks. Under MHA wk and wv are pruned with their head; under GQA
the shared kv heads stay. FLAP's bias compensation is skipped, as the
reference skips it: the blocks have no biases.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch import tree as T
from repro_torch.sparsity.sparse_params import sparsity_of


def block_unit_scores(bp, stats, cfg) -> Dict[str, torch.Tensor]:
    """Per-unit fluctuation scores of one attention + MLP block."""
    out: Dict[str, torch.Tensor] = {}
    st_o = stats.get("wo")
    if st_o is not None:  # wo (H, hd, d); its tap is (T, H*hd)
        H, hd, _ = bp["attn"]["wo"].shape
        wnorm = torch.square(bp["attn"]["wo"].float()).sum(dim=2)
        out["heads"] = (st_o.fluctuation.reshape(H, hd) * wnorm).sum(dim=1)
    st_d = stats.get("w_down")
    if st_d is not None:  # w_down (ff, d); its tap is (T, ff)
        wnorm = torch.square(bp["mlp"]["w_down"].float()).sum(dim=1)
        out["channels"] = st_d.fluctuation * wnorm
    return out


def _standardize(x: torch.Tensor) -> torch.Tensor:
    return (x - x.mean()) / torch.clamp_min(x.std(correction=0), 1e-9)


def global_structured_masks(per_block_scores: List[Dict[str, torch.Tensor]],
                            sparsity: float) -> List[Dict[str, torch.Tensor]]:
    """Standardise each block's scores, keep the units at or above one
    global threshold (the k-th largest, k = round(units * (1 - sparsity))):
    per block {heads: (H,), channels: (ff,)} bool unit masks."""
    std_scores = [{k: _standardize(v) for k, v in s.items()} for s in per_block_scores]
    allv = torch.cat([v.reshape(-1) for s in std_scores for v in s.values()])
    k = max(1, int(round(allv.numel() * (1.0 - sparsity))))
    thresh = torch.sort(allv).values[-k]
    out = []
    for s in std_scores:
        m = {name: v >= thresh for name, v in s.items()}
        for name, mm in m.items():  # never prune every head / channel of a block
            if not bool(mm.any()):
                mm[torch.argmax(s[name])] = True
        out.append(m)
    return out


def expand_block_masks(bp, unit: Dict[str, torch.Tensor], masks_bp):
    """Broadcast unit masks into a copy of the block's elementwise bool mask
    tree."""
    new = T.tree_map(lambda m: m, masks_bp)
    attn, mlp = bp["attn"], bp["mlp"]

    def bcast(um, view, like):
        return um.reshape(view).expand(like.shape).clone()

    if "heads" in unit:
        hm = unit["heads"]
        H = attn["wo"].shape[0]
        new["attn"]["wq"] = bcast(hm, (1, H, 1), attn["wq"])
        new["attn"]["wo"] = bcast(hm, (H, 1, 1), attn["wo"])
        if attn["wk"].shape[1] == H:  # MHA: kv go with their head; GQA keeps them
            for name in ("wk", "wv"):
                new["attn"][name] = bcast(hm, (1, H, 1), attn[name])
    if "channels" in unit:
        cm = unit["channels"]
        new["mlp"]["w_up"] = bcast(cm, (1, -1), mlp["w_up"])
        if "w_gate" in mlp:
            new["mlp"]["w_gate"] = bcast(cm, (1, -1), mlp["w_gate"])
        new["mlp"]["w_down"] = bcast(cm, (-1, 1), mlp["w_down"])
    return new


def remaining_param_fraction(masks, params) -> float:
    return 1.0 - sparsity_of(masks, params)
