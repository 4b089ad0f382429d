"""The distributed layer (port of ``repro.distributed``): the sharding
rules, head padding, the EBFT walk's ``MeshPlan``, the activation and
FSDP hooks, and the kernels' rules on DTensor shards."""
