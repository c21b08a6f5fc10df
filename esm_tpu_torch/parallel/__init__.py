"""Parallelism on ``torch.distributed``: the (data, fsdp, tp) device mesh
(``mesh``), ring attention for sequence parallelism (``ring_attention``),
and memory planning for one device (``memory_plan``). Parameter sharding,
the GPipe pipeline, the sharded fold, the scaling model and the mesh memory
plan are not ported yet (ROADMAP Queue 1, item 13b)."""
