"""esm-if-sample: design sequences for a backbone with ESM-IF1, on the port.

Port of esm_tpu/cli/if_sample.py (reference semantics:
examples/inverse_folding/sample_sequences.py). Same flags and output: the
native sequence and each sample printed with its recovery, the samples
written to a FASTA as ``sampled_seq_{i}``. ``--multichain-backbone``
conditions on every chain of the file and designs ``--chain`` (default the
first). Structures (.pdb, .cif) are read without biotite (data/pdb.py).

Runs on the GPU; --nogpu runs on the CPU, and without a GPU the run raises
unless --nogpu is given. Run it as ``python -m esm_tpu_torch.cli.if_sample``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def create_parser():
    parser = argparse.ArgumentParser(description="Sample sequences based on a given structure.")
    parser.add_argument("pdbfile", type=str, help="input filepath, either .pdb or .cif")
    parser.add_argument("--chain", type=str, help="chain id for the chain of interest", default=None)
    parser.add_argument("--temperature", type=float, help="temperature for sampling, higher for more diversity", default=1.0)
    parser.add_argument("--outpath", type=str, help="output filepath for saving sampled sequences", default="sampled_seqs.fasta")
    parser.add_argument("--num-samples", type=int, help="number of sequences to sample", default=1)
    parser.add_argument("--model", type=str, default="esm_if1_gvp4_t16_142M_UR50", help="model name or local .pt path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--multichain-backbone", action="store_true",
        help="use the backbones of all chains in the input for conditioning"
    )
    parser.add_argument("--nogpu", action="store_true", help="run on the host CPU even when a GPU is present")
    return parser


def run(args):
    from .. import pretrained
    from ..models.inverse_folding import multichain, util

    model, alphabet = pretrained.load_model_and_alphabet(
        args.model, device="cpu" if args.nogpu else None)

    outpath = Path(args.outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    if args.multichain_backbone:
        coords, native_seqs = multichain.extract_coords_from_complex(
            util.load_structure(args.pdbfile))
        target_chain = args.chain or next(iter(coords))
        native_seq = native_seqs[target_chain]
        print(f"Native sequence loaded from structure file ({target_chain}):")
    else:
        coords, native_seq = util.load_coords(args.pdbfile, args.chain)
        print("Native sequence loaded from structure file:")
    print(native_seq)

    with open(outpath, "w") as f:
        for i in range(args.num_samples):
            print(f"\nSampling.. ({i+1} of {args.num_samples})")
            if args.multichain_backbone:
                seq = multichain.sample_sequence_in_complex(
                    model.model, alphabet, coords, target_chain,
                    temperature=args.temperature, seed=args.seed + i)
            else:
                seq = model.sample(coords, temperature=args.temperature, seed=args.seed + i)
            print("Sampled sequence:")
            print(seq)
            f.write(f">sampled_seq_{i+1}\n{seq}\n")
            recovery = np.mean([a == b for a, b in zip(native_seq, seq)])
            print("Sequence recovery:", recovery)


def main():
    run(create_parser().parse_args())


if __name__ == "__main__":
    main()
