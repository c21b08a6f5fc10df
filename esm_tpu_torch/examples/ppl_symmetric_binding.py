"""Protein-programming-language example (the script form of the reference's
examples/protein-programming-language/programs/symmetric_binding.py): a
symmetric ring of identical binder protomers, each scaffolding the same
constant binding-site motif.

The reference fetches PDB 1y6k (IL-10) from RCSB and slices the epitope at
residues 31-40. Here the structure is a local file; the residue-range
default matches the reference.

Port of examples/ppl_symmetric_binding.py. ESMFold v1 comes from the local cache
(ESM_TPU_CACHE); on the card it folds with the fast preset (K1 in the LM,
K6 in the trunk):

  python -m esm_tpu_torch.examples.ppl_symmetric_binding 1y6k.pdb --chain A
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pdbfile",
                   help="structure holding the binding-site motif (reference uses 1y6k)")
    p.add_argument("--chain", default=None)
    p.add_argument("--site-start", type=int, default=31,
                   help="first motif residue (author numbering)")
    p.add_argument("--site-end", type=int, default=40, help="one past the last motif residue")
    p.add_argument("--num-binding-sites", type=int, default=3)
    p.add_argument("--flank-length", type=int, default=45)
    p.add_argument("--steps", type=int, default=2000)
    return p


def run(args, device=None):
    """Returns the final annealing state. ``device``: the card unless "cpu"
    is asked for."""
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.examples.ppl_common import anneal, esmfold_callback

    site = ppl.pdb_file_to_atomview(args.pdbfile, chain=args.chain)
    program = ppl.symmetric_binding(
        site,
        residue_range=(args.site_start, args.site_end),
        num_binding_sites=args.num_binding_sites,
        flank_length=args.flank_length,
    )
    state = anneal(program, esmfold_callback(device), args.steps)
    print("best energy:", state.best_energy)
    print("best sequence:", state.best_sequence)
    return state


if __name__ == "__main__":
    run(create_parser().parse_args())
