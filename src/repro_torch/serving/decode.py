"""Batched serving: prefill + decode loops with continuous batching (port
of ``repro.serving.decode``).

``Server`` wraps a Model's prefill and decode steps and a minimal
continuous-batching scheduler: a fixed pool of B slots; finished sequences
free their slot and queued requests are prefilled into it. The KV cache is
allocated once (B, max_len) and slots are recycled. Sparse (EBFT-tuned)
weights drop straight in, since the serve path reads the same params as
training.

The scheduler keeps the reference's semantics exactly, quirks included:

  * ``len`` is one host int shared by every slot and merges by max, so a
    request admitted mid-run is prefilled at positions 0..S-1 of its slot
    and its first decode lands at the shared ``len``: the zero keys in
    between are not masked;
  * ``generate`` left-pads its prompts with token 0, unmasked;
  * a request's first token is an argmax whatever the temperature, every
    slot decodes every step (an empty one from its last token, 0 before
    its first request), and the token count includes one prefill token
    per request.

Sampling is greedy (argmax) or, with ``temperature > 0``, a categorical
draw from a ``torch.Generator`` seeded by ``seed``: the port does not
re-create ``jax.random``, so only greedy output equals the reference's
token for token. The steps are ``obs.profile.profiled`` as
``serve/prefill`` and ``serve/decode``; ``serve`` books the reference's
``serve/batch`` span and ``serve/*`` metrics while an obs run is live.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import profiled


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 32
    out: Optional[List[int]] = None


class Server:
    """Serves ``model`` with ``params`` on their device (the embedding's)."""

    def __init__(self, model, params, batch_size: int, max_len: int, temperature: float = 0.0):
        self.model = model
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.device = params["embed"]["tok"].device
        # profiled: the first call per signature apart from the steady state
        # (one branch around the raw step while observability is off)
        self._prefill = profiled(model.prefill, "serve/prefill")
        self._decode = profiled(model.decode_step, "serve/decode")

    def _state(self, batch: int, max_len: int):
        return self.model.init_serve_state(batch, max_len, self.device)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(toks, device=self.device)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        logits = logits[:, -1]
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: List[np.ndarray], max_new: int = 32, seed: int = 0):
        """One-shot batched generation (prompts left-padded to the longest)."""
        if len(prompts) > self.B:
            raise ValueError(f"generate: {len(prompts)} prompts for {self.B} slots")
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = np.zeros((B, S), np.int32)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p  # left-pad so last position aligns
        state = self._state(B, S + max_new)
        logits, state = self._prefill(self.params, {"tokens": self._tokens(toks)}, state)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs: List[List[int]] = [[] for _ in range(B)]
        tok = self._sample(logits, gen)
        for _ in range(max_new):
            # obs: sync-ok (the host hands the sampled tokens back)
            for i, t in enumerate(tok.tolist()):
                outs[i].append(t)
            logits, state = self._decode(self.params, tok[:, None], state)
            tok = self._sample(logits, gen)
        return outs

    # ------------------------------------------------------------------
    def serve(self, requests: List[Request], seed: int = 0) -> Dict[int, List[int]]:
        """Continuous batching: slots are freed as sequences finish and
        refilled from the queue, each new request prefilled alone into its
        slot."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        active: List[Optional[Request]] = [None] * self.B
        remaining = [0] * self.B
        state = self._state(self.B, self.max_len)
        last_tok = torch.zeros((self.B, 1), dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        obs_on = OT.enabled()
        tokens_out = 0
        t_start = time.perf_counter()

        def admit():
            nonlocal state
            for slot in range(self.B):
                if active[slot] is None and queue:
                    req = queue.pop(0)
                    active[slot] = req
                    req.out = []
                    remaining[slot] = req.max_new
                    # single-sequence prefill into this slot
                    sub = self._state(1, self.max_len)
                    logits, sub = self._prefill(
                        self.params, {"tokens": self._tokens(req.prompt[None])}, sub)
                    state = {k: _slot_update(state[k], sub[k], slot) for k in state}
                    tok = int(torch.argmax(logits[0, -1]))
                    req.out.append(tok)
                    last_tok[slot, 0] = tok
                    remaining[slot] -= 1
            if obs_on:
                OM.gauge("serve/queue_depth").set(len(queue))

        with OT.span("serve/batch", requests=len(requests), slots=self.B):
            admit()
            while any(a is not None for a in active):
                if obs_on:
                    # occupancy: fraction of slots doing useful decode work
                    OM.histogram("serve/batch_occupancy").observe(
                        sum(1 for a in active if a is not None) / self.B)
                logits, state = self._decode(self.params, last_tok, state)
                tok = self._sample(logits, gen)
                # obs: sync-ok (the host needs the sampled token to retire requests)
                for slot, t in enumerate(tok.tolist()):
                    req = active[slot]
                    if req is None:
                        continue
                    req.out.append(t)
                    remaining[slot] -= 1
                    tokens_out += 1
                    if remaining[slot] <= 0:
                        results[req.uid] = req.out
                        active[slot] = None
                last_tok = tok[:, None]
                admit()
            if obs_on:
                dt = time.perf_counter() - t_start
                tokens_out += len(results)  # one prefill token per request
                OM.counter("serve/tokens").inc(tokens_out)
                OM.counter("serve/requests").inc(len(results))
                OM.gauge("serve/tokens_per_s").set(tokens_out / max(dt, 1e-9))
        return results


def _slot_update(full, one, slot: int):
    """Write a single-sequence state leaf into batch slot ``slot`` of the
    full one, in place. The batch dim is the first dim where the shapes
    differ (full B, one 1); the host int ``len`` merges by max (the shared
    counter); equal shapes (B == 1) are shared state, which ``one``
    replaces. A dict (the MoE family's ``dense`` and ``moe`` cache groups)
    is updated leaf by leaf."""
    if isinstance(full, dict):
        return {k: _slot_update(full[k], one[k], slot) for k in full}
    if not isinstance(full, torch.Tensor):
        return max(full, one)
    for axis in range(full.dim()):
        if full.shape[axis] != one.shape[axis]:
            full.narrow(axis, slot, 1).copy_(one)
            return full
    return one.to(full.dtype)
