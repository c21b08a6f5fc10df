"""What the protein-programming-language examples share: ESMFold v1 from
the local cache (ESM_TPU_CACHE) behind a folding callback, and the
annealing run with the reference recipes' settings."""

from __future__ import annotations

import logging


def esmfold_callback(device=None):
    """``ESMFoldCallback`` over ``pretrained.esmfold_v1`` with one recycle.
    On the card the fold runs the fast preset: the bf16 LM through K1, the
    bf16 trunk through K6."""
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.apps import ppl

    device = pretrained.resolve_device(device)
    handle = pretrained.esmfold_v1(fast=device.type == "cuda", device=device)
    return ppl.ESMFoldCallback(handle, num_recycles=1)


def anneal(program, callback, steps: int):
    """Simulated annealing from T=1.0 at a rate of 0.97 a step (the
    reference recipes' settings), logging progress."""
    from esm_tpu_torch.apps import ppl

    logging.basicConfig(level=logging.INFO)
    return ppl.run_simulated_annealing(
        program,
        callback,
        initial_temperature=1.0,
        annealing_rate=0.97,
        total_num_steps=steps,
    )
