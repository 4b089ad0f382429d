"""Seeded-violation configs for the port's static analyzer.

Loaded by ``python -m repro_torch.analysis --extra-config-module
_torch_analysis_fixtures`` (tests on the path) and by
tests/test_torch_analysis.py directly. Each config plants one specific
error-severity violation the analyzer must catch:

* ``bad_tiles`` — d_ff=999 (the reference fixture's number): the MLP's
  bf16 K and N are not multiples of 8, so the bf16 GEMM's builder refuses
  them -> KER001 (and K=999 has no 2:4 groups -> KER005);
* ``bad_heads`` — num_heads=5 with num_kv_heads=2: GQA grouping broken
  -> CFG002;
* ``bad_head_width`` — head_dim=256: the attention kernels are compiled at
  head widths 16, 32, 64 and 128 -> KER001.

Kept tiny so they double as their own smoke variants for the trace passes.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

BAD_TILES = ModelConfig(
    name="bad_tiles", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=999, vocab_size=256,
)

BAD_HEADS = ModelConfig(
    name="bad_heads", family="dense", num_layers=2, d_model=64,
    num_heads=5, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
)

BAD_HEAD_WIDTH = ModelConfig(
    name="bad_head_width", family="dense", num_layers=2, d_model=64,
    num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=256,
)

ANALYSIS_CONFIGS = [("bad_tiles", BAD_TILES), ("bad_heads", BAD_HEADS),
                    ("bad_head_width", BAD_HEAD_WIDTH)]
