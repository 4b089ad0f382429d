"""Roofline constants and the model FLOP count (the part of
``repro.launch.rooflines`` that ``obs.profile.record_kernel`` and the
launchers need), for one NVIDIA H100 SXM:

    peak bf16 compute   989 TFLOP/s  (NVIDIA H100 data sheet, SXM, dense
                                      tensor-core rate, no sparsity)
    HBM bandwidth       3.35 TB/s    (the same data sheet, HBM3)

Both assume the card's full 700 W power limit; a card set below it runs
slower under load, so a roofline share is stated with the card's power
limit beside it. The reference's ``terms()`` reads a compiled program's
HLO statistics, which have no torch counterpart; it waits with
``launch/hlo_analysis.py`` (ROADMAP.md A.7).

``model_flops_per_chip`` is the classic parameter-math lower bound:
6·N·D for training (forward + backward), 2·N·D for inference, and for an
``ebft`` shape one block's forward + backward over the calibration batch.
Only the dense family is ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12   # bf16 FLOP/s, dense
HBM_BW = 3.35e12      # bytes/s


def model_flops_per_chip(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> float:
    """The reference's count for the dense family (embedding lookups are
    table reads, not FLOPs; the LM head is a matmul and is in
    ``param_count``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"model FLOPs of family {cfg.family!r} "
                                  "(ROADMAP.md queue A.5)")
    n = cfg.param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens / chips
    if shape.kind == "prefill":
        return 2.0 * n * tokens / chips
    if shape.kind == "ebft":
        embed = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        n_block = (n - embed) / max(cfg.num_layers, 1)
        return 6.0 * n_block * tokens / chips
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch / chips
