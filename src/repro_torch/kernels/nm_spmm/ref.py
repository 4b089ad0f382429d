"""Plain PyTorch version of the N:M sparse matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.sparsity.sparse_params import nm_decompress


def nm_spmm_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, *, n: int,
                  m: int) -> torch.Tensor:
    """out = x @ nm_decompress(vals, idx), accumulated in f32, cast back to
    x.dtype (``repro.kernels.nm_spmm.ref``)."""
    w = nm_decompress(vals, idx, n, m)
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)
