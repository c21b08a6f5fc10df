"""esm-if-score: score sequences against a backbone with ESM-IF1, on the port.

Port of esm_tpu/cli/if_score.py (reference semantics:
examples/inverse_folding/score_log_likelihoods.py). Same flags and output:
a CSV ``seqid,log_likelihood,log_likelihood_withcoord`` with one row per
FASTA record, the average log-likelihood over the whole sequence and over
the residues with coordinates. ``--multichain-backbone`` scores ``--chain``
(default the first) conditioned on every chain of the file. Structures are
read without biotite (data/pdb.py).

Runs on the GPU; --nogpu runs on the CPU, and without a GPU the run raises
unless --nogpu is given. Run it as ``python -m esm_tpu_torch.cli.if_score``.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def create_parser():
    parser = argparse.ArgumentParser(
        description="Score sequences based on a given structure."
    )
    parser.add_argument("pdbfile", type=str, help="input filepath, either .pdb or .cif")
    parser.add_argument("seqfile", type=str, help="input filepath for variant sequences in fasta format")
    parser.add_argument("--chain", type=str, help="chain id for the chain of interest", default=None)
    parser.add_argument("--outpath", type=str, help="output filepath for scores of variant sequences", default="output/sequence_scores.csv")
    parser.add_argument("--model", type=str, default="esm_if1_gvp4_t16_142M_UR50", help="model name or local .pt path")
    parser.add_argument(
        "--multichain-backbone", action="store_true",
        help="use the backbones of all chains in the input for conditioning"
    )
    parser.add_argument("--nogpu", action="store_true", help="run on the host CPU even when a GPU is present")
    return parser


def run(args):
    from .. import pretrained
    from ..data import read_fasta
    from ..models.inverse_folding import multichain, util

    model, alphabet = pretrained.load_model_and_alphabet(
        args.model, device="cpu" if args.nogpu else None)

    seqs = list(read_fasta(args.seqfile))
    outpath = Path(args.outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    if args.multichain_backbone:
        coords, _ = multichain.extract_coords_from_complex(util.load_structure(args.pdbfile))
        target_chain = args.chain or next(iter(coords))

        def score(seq):
            return multichain.score_sequence_in_complex(model.model, alphabet, coords,
                                                        target_chain, seq)
    else:
        coords, _ = util.load_coords(args.pdbfile, args.chain)

        def score(seq):
            return model.score_sequence(coords, seq)

    with open(outpath, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["seqid", "log_likelihood", "log_likelihood_withcoord"])
        for header, seq in seqs:
            ll, llc = score(seq)
            writer.writerow([header, ll, llc])
            print(f"{header}: {ll:.3f} (full) {llc:.3f} (with coords)")
    print(f"Results saved to {outpath}")


def main():
    run(create_parser().parse_args())


if __name__ == "__main__":
    main()
