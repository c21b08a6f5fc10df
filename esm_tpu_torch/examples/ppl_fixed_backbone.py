"""Protein-programming-language example (the script form of the reference's
examples/protein-programming-language/programs/fixed_backbone.py): redesign a
sequence for a known backbone by minimizing cRMSD/dRMSD to a PDB template
while maximizing pTM/pLDDT. Pass any local PDB file as the template.

Port of examples/ppl_fixed_backbone.py. ESMFold v1 comes from the local cache
(ESM_TPU_CACHE); on the card it folds with the fast preset (K1 in the LM,
K6 in the trunk):

  python -m esm_tpu_torch.examples.ppl_fixed_backbone template.pdb --steps 2000
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pdbfile", help="template PDB (e.g. a 6mrs download)")
    p.add_argument("--chain", default=None)
    p.add_argument("--steps", type=int, default=2000)
    return p


def run(args, device=None):
    """Returns the final annealing state. ``device``: the card unless "cpu"
    is asked for."""
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.examples.ppl_common import anneal, esmfold_callback

    template = ppl.pdb_file_to_atomview(args.pdbfile, chain=args.chain)
    program = ppl.fixed_backbone(template)
    state = anneal(program, esmfold_callback(device), args.steps)
    print("best sequence:", state.best_sequence)
    print("best energy:", state.best_energy)
    return state


if __name__ == "__main__":
    run(create_parser().parse_args())
