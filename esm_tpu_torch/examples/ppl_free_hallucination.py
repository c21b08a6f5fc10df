"""Protein-programming-language example (the script form of the reference's
examples/protein-programming-language/programs/free_hallucination.py):
hallucinate a confident, soluble monomer from scratch by maximizing pTM and
pLDDT while keeping hydrophobics off the surface.

Port of examples/ppl_free_hallucination.py. ESMFold v1 comes from the local cache
(ESM_TPU_CACHE); on the card it folds with the fast preset (K1 in the LM,
K6 in the trunk):

  python -m esm_tpu_torch.examples.ppl_free_hallucination --length 100 --steps 2000
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--length", type=int, default=100)
    p.add_argument("--steps", type=int, default=2000)
    return p


def run(args, device=None):
    """Returns the final annealing state. ``device``: the card unless "cpu"
    is asked for."""
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.examples.ppl_common import anneal, esmfold_callback

    callback = esmfold_callback(device)
    program = ppl.free_hallucination(args.length)
    state = anneal(program, callback, args.steps)
    print("best energy:", state.best_energy)
    print("best sequence:", state.best_sequence)
    return state


if __name__ == "__main__":
    run(create_parser().parse_args())
