"""Parallelism over one process per rank: the device mesh and its process
groups (:mod:`.state`, :mod:`.multihost`), the Megatron collective regions
and the pipeline's point-to-point sends (:mod:`.mappings`), the
tensor-parallel layers with the JAX package's parameter layouts
(:mod:`.layers`), which part of each leaf a rank holds (:mod:`.layout`),
the vocab-parallel loss, the sharded gradient norm, head padding and the
per-rank random streams."""
