"""Lint of traced hot paths (the port's counterpart of
``repro.analysis.jaxpr_lint``), over the aten graph ``graph_utils.trace``
records of the EBFT tune step and the serving decode step (any graph,
really):

  * LNT001 (warn)  silent float widenings outside accumulators: a cast
    (``_to_copy``) that widens a float dtype (bf16 -> f32) whose result
    feeds anything other than a contraction or a reduction — elementwise
    math silently runs at the wider dtype and doubles its memory traffic;
  * LNT002 (error) host reads: ``_local_scalar_dense`` (``.item()``,
    ``float(t)``, ``bool(t)``), ``equal``, and the operations whose output
    size depends on the data (``nonzero``, ``bincount``,
    ``masked_select``, ``unique``, ``repeat_interleave`` by a tensor of
    counts). On the card each one blocks the host until the stream drains,
    once a step;
  * LNT003 (info)  degenerate cast round-trips A -> B -> A — the inner
    cast is lossy (if narrowing) or dead (if not), either way unintended.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import (call_nodes, dtype_of, op_name, var_consumers,
                                              var_producers)

HOST_READS = frozenset({"_local_scalar_dense", "item", "equal", "is_nonzero", "nonzero",
                        "nonzero_static", "argwhere", "bincount", "masked_select",
                        "unique", "_unique", "_unique2", "unique_consecutive", "unique_dim"})
_CASTS = frozenset({"_to_copy", "to", "convert_element_type"})
# consumers for which a widening cast is an accumulator idiom, not a bug
ACCUMULATOR_CONSUMERS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
                                   "einsum", "sum", "mean", "amax", "amin", "prod", "max",
                                   "min", "logsumexp"})


def _is_host_read(node: torch.fx.Node) -> bool:
    name = op_name(node)
    if name in HOST_READS:
        return True
    # repeat_interleave by a tensor of counts sizes its output from the data
    # unless the caller passes output_size
    return (name == "repeat_interleave"
            and isinstance(node.args[1] if len(node.args) > 1 else node.args[0], torch.fx.Node)
            and node.kwargs.get("output_size") is None)


def _is_float(dtype) -> bool:
    return dtype is not None and dtype.is_floating_point


def lint_graph(gm: torch.fx.GraphModule, where: str, config: str = "") -> List[Finding]:
    findings: List[Finding] = []
    seen = set()

    def emit(code, severity, loc, message):
        key = (code, loc, message)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            code=code, severity=severity, pass_name="graph",
            config=config, location=loc, message=message,
        ))

    producers = var_producers(gm)
    consumers = var_consumers(gm)
    for node in call_nodes(gm):
        name = op_name(node)
        if _is_host_read(node):
            emit("LNT002", "error", f"{where}:{name}",
                 f"host read `{name}` inside a hot path — on the card it blocks the host "
                 "until the stream drains, every step")
        if name not in _CASTS or not node.args or not isinstance(node.args[0], torch.fx.Node):
            continue
        src = node.args[0]
        src_dt, out_dt = dtype_of(src), dtype_of(node)
        if src_dt is None or out_dt is None or src_dt == out_dt:
            continue

        # LNT003: A -> B -> A round trip
        prod = producers.get(src, src)
        if (op_name(prod) in _CASTS and prod.args and isinstance(prod.args[0], torch.fx.Node)
                and dtype_of(prod.args[0]) == out_dt):
            emit("LNT003", "info", f"{where}:convert",
                 f"degenerate convert round-trip {str(out_dt)[6:]} -> {str(src_dt)[6:]} -> "
                 f"{str(out_dt)[6:]}")

        # LNT001: silent float widening outside accumulators
        if _is_float(src_dt) and _is_float(out_dt) and out_dt.itemsize > src_dt.itemsize:
            cons = [c for c in consumers.get(node, []) if c.op == "call_function"]
            if cons and all(op_name(c) in ACCUMULATOR_CONSUMERS for c in cons):
                continue
            emit("LNT001", "warn", f"{where}:convert",
                 f"silent float widening {str(src_dt)[6:]} -> {str(out_dt)[6:]} outside an "
                 "accumulator — elementwise math runs at the wider dtype and doubles memory "
                 "traffic")
    return findings
