"""Evaluation: held-out perplexity (port of ``repro.core.evaluate``)."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

Params = Any


@torch.no_grad()
def perplexity(model, params: Params, tokens: np.ndarray, microbatch: int = 8,
               masks: Optional[Params] = None) -> float:
    """exp(mean next-token NLL) over the evaluation segments, each
    microbatch weighted by its row count. With ``masks`` every masked
    linear runs through the masked matmul kernel."""
    device = params["embed"]["tok"].device
    tot = torch.zeros((), dtype=torch.float32, device=device)
    n = 0
    for s in range(0, tokens.shape[0], microbatch):
        batch = {"tokens": torch.as_tensor(tokens[s:s + microbatch], device=device)}
        loss, m = model.loss(params, batch, masks)
        b = batch["tokens"].shape[0]
        tot = tot + m["nll"] * b
        n += b
    return float(np.exp(float(tot) / max(n, 1)))
