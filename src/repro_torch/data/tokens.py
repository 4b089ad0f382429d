"""Synthetic token data pipeline.

The container has no C4 / Wikitext2 on disk, so we build a deterministic
synthetic corpus with enough statistical structure that language-modelling
loss is meaningful and pruning hurts it (DESIGN.md §7):

* a Zipf-distributed unigram backbone (natural-language-like frequencies),
* a first-order Markov kernel so contexts carry information (models that
  capture bigram structure beat the unigram entropy floor),
* deterministic "template" n-grams injected at random offsets, giving
  mid-range structure that block fine-tuning can recover.

Two consumers:
  - ``corpus_iterator``: packed (B, S) batches for pre-training / eval.
  - ``calibration_set``: the paper's D_c — N segments of ``seq_len`` tokens
    (paper: 256 x 1024 from C4) sampled with a fixed seed.

Everything is pure-numpy on the host (the real system would stream from a
tokenised dataset service); device placement happens in the train loop.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab_size: int
    zipf_a: float = 1.2          # Zipf exponent for the unigram backbone
    markov_rank: int = 16        # low-rank bigram kernel size
    markov_weight: float = 0.55  # interpolation: P = w*bigram + (1-w)*unigram
    n_templates: int = 64        # injected deterministic n-grams
    template_len: int = 8
    template_rate: float = 0.05  # fraction of positions starting a template
    seed: int = 0


class SyntheticCorpus:
    """Deterministic synthetic corpus sampler (Zipf + low-rank Markov)."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size

        # Zipf unigram distribution over the vocab.
        ranks = np.arange(1, V + 1, dtype=np.float64)
        uni = ranks ** (-cfg.zipf_a)
        self.unigram = uni / uni.sum()

        # Low-rank Markov structure: token -> cluster -> next-token tilt.
        R = cfg.markov_rank
        self.tok2cluster = rng.integers(0, R, size=V)
        # per-cluster tilt: a random permutation bias over a slice of the vocab
        tilt = rng.dirichlet(np.full(V, 0.05), size=R)
        self.cluster_next = 0.5 * tilt + 0.5 * self.unigram[None, :]
        self.cluster_next /= self.cluster_next.sum(-1, keepdims=True)

        # deterministic templates (frequent n-grams)
        self.templates = rng.integers(
            0, max(2, V // 8), size=(cfg.n_templates, cfg.template_len)
        )

        # The sampling CDFs, built once as ``Generator.choice(V, p=p)``
        # builds them on every call (``cdf = p.cumsum(); cdf /= cdf[-1]``,
        # then one ``random()`` searched with side="right"): the same draws,
        # bit for bit, in O(log V) a token instead of O(V).
        self._cdf_unigram = _cdf(self.unigram)
        self._cdf_next = [
            _cdf(cfg.markov_weight * self.cluster_next[c]
                 + (1 - cfg.markov_weight) * self.unigram)
            for c in range(R)
        ]

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(length, dtype=np.int32)
        prev = _choice(rng, self._cdf_unigram)
        i = 0
        while i < length:
            if rng.random() < cfg.template_rate:
                t = self.templates[rng.integers(cfg.n_templates)]
                n = min(len(t), length - i)
                out[i : i + n] = t[:n]
                i += n
                prev = int(out[i - 1])
                continue
            prev = _choice(rng, self._cdf_next[self.tok2cluster[prev]])
            out[i] = prev
            i += 1
        return out


def _cdf(p: np.ndarray) -> np.ndarray:
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def _choice(rng: np.random.Generator, cdf: np.ndarray) -> int:
    """``int(rng.choice(len(cdf), p=p))`` for the ``cdf`` of ``p``."""
    return int(cdf.searchsorted(rng.random(), side="right"))


def corpus_iterator(
    corpus: SyntheticCorpus,
    batch: int,
    seq_len: int,
    seed: int = 1234,
) -> Iterator[np.ndarray]:
    """Yields packed (batch, seq_len) int32 batches forever."""
    rng = np.random.default_rng(seed)
    while True:
        yield np.stack([corpus.sample(rng, seq_len) for _ in range(batch)])


def calibration_set(
    corpus: SyntheticCorpus, n_samples: int, seq_len: int, seed: int = 42
) -> np.ndarray:
    """The paper's D_c: ``n_samples`` segments of ``seq_len`` tokens.

    Paper setting: 256 segments x 1024 tokens from C4. Fixed seed so every
    pruning/fine-tuning method sees the identical calibration set.
    """
    rng = np.random.default_rng(seed)
    return np.stack([corpus.sample(rng, seq_len) for _ in range(n_samples)])


def eval_set(
    corpus: SyntheticCorpus, n_samples: int, seq_len: int, seed: int = 7777
) -> np.ndarray:
    """Held-out evaluation segments (our Wikitext2 stand-in)."""
    rng = np.random.default_rng(seed)
    return np.stack([corpus.sample(rng, seq_len) for _ in range(n_samples)])


def cloze_task(
    corpus: SyntheticCorpus, n_samples: int, seq_len: int, seed: int = 555
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic zero-shot-style cloze task (our Tab.3 stand-in).

    Each sample ends with a template prefix; the task is to rank the true
    template continuation above a corrupted one. Returns
    (contexts (N, seq_len), true_next (N,), distractor_next (N,)).
    """
    cfg = corpus.cfg
    rng = np.random.default_rng(seed)
    ctx = np.empty((n_samples, seq_len), np.int32)
    true_next = np.empty((n_samples,), np.int32)
    distract = np.empty((n_samples,), np.int32)
    for i in range(n_samples):
        body = corpus.sample(rng, seq_len)
        t = corpus.templates[rng.integers(cfg.n_templates)]
        k = len(t) - 1
        body[-k:] = t[:k]
        ctx[i] = body
        true_next[i] = t[k]
        d = int(rng.integers(cfg.vocab_size))
        while d == t[k]:
            d = int(rng.integers(cfg.vocab_size))
        distract[i] = d
    return ctx, true_next, distract
