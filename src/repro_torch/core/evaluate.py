"""Evaluation: held-out perplexity (the WikiText2 stand-in) and the
synthetic cloze ranking task (the zero-shot suite's stand-in, Tab. 3)
(port of ``repro.core.evaluate``)."""
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


@torch.no_grad()
def cloze_accuracy(model, params: Params, ctx: np.ndarray, true_next: np.ndarray,
                   distract: np.ndarray, microbatch: int = 8,
                   masks: Optional[Params] = None) -> float:
    """Fraction of samples whose final-position logit ranks the true
    continuation above the distractor. ``ctx`` (N, S), ``true_next`` and
    ``distract`` (N,). The hits accumulate on the device; one sync at the
    end. With ``masks`` every masked linear runs through the masked matmul
    kernel."""
    device = params["embed"]["tok"].device
    correct = torch.zeros((), dtype=torch.int64, device=device)
    n = 0
    for s in range(0, ctx.shape[0], microbatch):
        lg = model.forward(params, {"tokens": torch.as_tensor(ctx[s:s + microbatch],
                                                                device=device)}, masks)[:, -1]
        t = torch.as_tensor(true_next[s:s + microbatch], device=device).long()
        d = torch.as_tensor(distract[s:s + microbatch], device=device).long()
        idx = torch.arange(lg.shape[0], device=device)
        correct += (lg[idx, t] > lg[idx, d]).sum()
        n += lg.shape[0]
    return int(correct) / max(n, 1)
