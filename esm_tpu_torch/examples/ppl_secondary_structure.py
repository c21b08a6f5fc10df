"""Protein-programming-language example (the script form of the reference's
examples/protein-programming-language/programs/secondary_structure.py):
hallucinate a two-segment protein while steering each segment's secondary
structure ('a' helix, 'b' strand, 'c' coil).

Port of examples/ppl_secondary_structure.py. ESMFold v1 comes from the local cache
(ESM_TPU_CACHE); on the card it folds with the fast preset (K1 in the LM,
K6 in the trunk):

  python -m esm_tpu_torch.examples.ppl_secondary_structure --node1-sse a --node2-sse b
"""

from __future__ import annotations

import argparse


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--node1-sse", default="a", choices=["a", "b", "c"])
    p.add_argument("--node2-sse", default="b", choices=["a", "b", "c"])
    p.add_argument("--segment-length", type=int, default=50)
    p.add_argument("--steps", type=int, default=2000)
    return p


def run(args, device=None):
    """Returns the final annealing state. ``device``: the card unless "cpu"
    is asked for."""
    from esm_tpu_torch.apps import ppl
    from esm_tpu_torch.examples.ppl_common import anneal, esmfold_callback

    callback = esmfold_callback(device)
    program = ppl.secondary_structure(
        args.node1_sse, args.node2_sse, segment_length=args.segment_length
    )
    state = anneal(program, callback, args.steps)
    print("best energy:", state.best_energy)
    print("best sequence:", state.best_sequence)
    return state


if __name__ == "__main__":
    run(create_parser().parse_args())
