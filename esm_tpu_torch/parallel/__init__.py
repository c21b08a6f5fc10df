"""Memory planning for one device (``memory_plan``). The multi-GPU parts of
esm_tpu/parallel (meshes, sharding, ring attention, pipelining, the model
and training plans, scaling) are not ported yet."""
