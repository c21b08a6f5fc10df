"""Unsupervised contact prediction, the script form of the reference's
examples/contact_prediction.ipynb: contacts for the sequences of a FASTA
file with ESM-2 (or for an MSA with the MSA Transformer), and long-range
precision@L against given true contact maps (esm_tpu_torch.metrics).

Port of examples/contact_prediction.py. The model comes from the local
cache (ESM_TPU_CACHE) or a .pt path:

  python -m esm_tpu_torch.examples.contact_prediction --model esm2_t33_650M_UR50D \\
      --fasta seqs.fasta [--targets-npz contacts.npz]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def create_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="esm2_t33_650M_UR50D")
    p.add_argument("--fasta", help="sequences to predict contacts for")
    p.add_argument("--msa", default=None, help=".a3m file for the MSA Transformer")
    p.add_argument("--msa-depth", type=int, default=64)
    p.add_argument("--msa-select", choices=["greedy", "first"], default="greedy",
                   help="subsampling: the diversity-maximizing greedy_select (the reference "
                   "notebook's method) or the first N rows")
    p.add_argument("--targets-npz", default=None,
                   help=".npz of {label: L x L binary contact map} to score precision@L against")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def main(args):
    from esm_tpu_torch import pretrained
    from esm_tpu_torch.data import greedy_select, read_fasta, read_msa
    from esm_tpu_torch.metrics import contact_precision

    device = pretrained.resolve_device("cpu" if args.cpu else None)
    targets = dict(np.load(args.targets_npz)) if args.targets_npz else None
    model, alphabet = pretrained.load_model_and_alphabet(args.model, device=device)
    results = {}
    with torch.no_grad():
        if model.kind == "msa":
            if not args.msa:
                raise SystemExit("the MSA Transformer needs --msa")
            full_msa = read_msa(args.msa)
            msa = (greedy_select(full_msa, num_seqs=args.msa_depth)
                   if args.msa_select == "greedy" else full_msa[:args.msa_depth])
            _, _, tokens = alphabet.get_batch_converter()([msa])
            contacts = model(tokens, return_contacts=True)["contacts"].float().cpu().numpy()[0]
            print(f"{msa[0][0]}: predicted {contacts.shape} contact map")
            results[msa[0][0]] = contacts
            return results
        if not args.fasta:
            raise SystemExit("--fasta is required for a sequence model")
        seqs = list(read_fasta(args.fasta))
        _, _, tokens = alphabet.get_batch_converter()(seqs)
        contacts = model(tokens, return_contacts=True)["contacts"].float().cpu().numpy()
    for k, (label, seq) in enumerate(seqs):
        L = len(seq)
        c = contacts[k, :L, :L]
        results[label] = c
        if targets is not None and label in targets:
            print(f"{label}: long-range precision@L = {contact_precision(c, targets[label]):.3f}")
            continue
        print(f"{label}: top contact pairs:")
        i, j = np.triu_indices(L, k=6)
        for o in np.argsort(-c[i, j])[:10]:
            print(f"  {i[o]:4d} - {j[o]:4d}  p={c[i[o], j[o]]:.3f}")
    return results


if __name__ == "__main__":
    main(create_parser().parse_args())
