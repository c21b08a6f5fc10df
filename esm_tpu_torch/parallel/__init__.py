"""Parallelism on ``torch.distributed``: the (data, fsdp, tp) device mesh
(``mesh``), ring attention for sequence parallelism (``ring_attention``),
parameter sharding of ESM-2 (``sharding``, its collectives in
``tensor_parallel``), the GPipe pipeline (``pipeline``), the memory plans
(``memory_plan``) and the scaling model (``scaling``). The sharded fold is
not ported yet (ROADMAP Queue 1, item 13c)."""
