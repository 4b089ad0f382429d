"""Tracing a function to an aten graph, and walking it (the port's
counterpart of ``repro.analysis.jaxpr_utils``).

``trace`` runs ``make_fx`` on CPU tensors: the function runs once, for
real, and every aten operation it dispatches (autograd's backward
included, when the function calls ``torch.autograd.grad``) becomes a node
of one flat ``torch.fx`` graph. Python loops are unrolled, and calls are
inlined, so the graph has no sub-graphs to recurse into (the jaxpr's scan,
while and cond bodies). A host read (``.item()``, a data-dependent size)
stays in the graph as a node instead of aborting the trace, so the lint can
report it. On the CPU every kernel wrapper takes its plain version, so the
graph shows what the model code asks of the kernels: a masked product is
the plain version's ``mul`` of the weight by its mask, then ``mm``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.fx
from torch.utils import _pytree as pytree


def trace(fn, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` as an aten graph; its placeholders are the leaves of
    ``args`` in ``torch.utils._pytree`` order (dicts by insertion)."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    for leaf in pytree.tree_leaves(args):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            raise ValueError(f"trace: takes CPU tensors, got one on {leaf.device}")
    # each node's metadata is a fake copy of its real output, made in the
    # fake mode the tracing context holds; without one, make_fx builds a new
    # mode (and records its Python stack) for every node, 40% of the time
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        return make_fx(fn, _error_on_data_dependent_ops=False)(*args)


def op_name(node: torch.fx.Node) -> str:
    """``mm`` for ``aten.mm.default``, ``getitem`` for ``operator.getitem``."""
    t = node.target
    return getattr(t, "_opname", None) or getattr(t, "__name__", str(t))


def call_nodes(gm: torch.fx.GraphModule) -> Iterator[torch.fx.Node]:
    """Every operation of the graph, in execution order."""
    for node in gm.graph.nodes:
        if node.op == "call_function":
            yield node


def placeholders(gm: torch.fx.GraphModule) -> List[torch.fx.Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def dtype_of(node: Any) -> Optional[torch.dtype]:
    """The dtype of the tensor a node produces (None for other values)."""
    val = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return getattr(val, "dtype", None)


def producer(node: torch.fx.Node) -> torch.fx.Node:
    """The operation behind a value: a multi-output op's ``getitem`` is
    its op's output."""
    while node.op == "call_function" and op_name(node) == "getitem":
        node = node.args[0]
    return node


def var_producers(gm: torch.fx.GraphModule) -> Dict[torch.fx.Node, torch.fx.Node]:
    """Map each value to the operation that produced it."""
    return {n: producer(n) for n in gm.graph.nodes if n.op != "output"}


def var_consumers(gm: torch.fx.GraphModule) -> Dict[torch.fx.Node, List[torch.fx.Node]]:
    """Map each value to the operations (and the graph's output) that read it."""
    return {n: list(n.users) for n in gm.graph.nodes}
