"""Parallelism on ``torch.distributed``: the (data, fsdp, tp) device mesh
(``mesh``), ring attention for sequence parallelism (``ring_attention``),
parameter sharding of the language models (``sharding``, its collectives in
``tensor_parallel``), the GPipe pipeline (``pipeline``), the memory plans
(``memory_plan``), the scaling model (``scaling``), and the collectives of
the sharded fold, ESMFold's pair tensors row-sharded over the mesh's tp
dimension (``pair_sharding``, run by ``models.esmfold.apply_sharded``)."""
