"""Protein-programming-language example (the script form of the reference's
examples/protein-programming-language/programs/symmetric_monomer.py): design
a single chain of N identical repeats arranged in a symmetric ring,
maximizing pTM/pLDDT with a symmetry energy.

Port of examples/ppl_symmetric_design.py. ESMFold v1 comes from the local cache
(ESM_TPU_CACHE); on the card it folds with the fast preset (K1 in the LM,
K6 in the trunk):

  python -m esm_tpu_torch.examples.ppl_symmetric_design --num-protomers 3 --protomer-length 50
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--protomer-length", type=int, default=50)
    p.add_argument("--num-protomers", type=int, default=3)
    p.add_argument("--steps", type=int, default=2000)
    return p


def run(args, device=None):
    """Returns the final annealing state. ``device``: the card unless "cpu"
    is asked for."""
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.examples.ppl_common import anneal, esmfold_callback

    callback = esmfold_callback(device)
    program = ppl.symmetric_monomer(args.num_protomers, protomer_length=args.protomer_length)
    state = anneal(program, callback, args.steps)
    print("best energy:", state.best_energy)
    print("best sequence:", state.best_sequence)
    return state


if __name__ == "__main__":
    run(create_parser().parse_args())
