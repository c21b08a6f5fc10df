"""esm-predict-variants: zero-shot variant-effect scoring of a deep
mutational scan, on the port.

Port of esm_tpu/cli/predict_variants.py (reference semantics:
examples/variant-prediction/predict.py). Strategies: wt-marginals (one
forward), masked-marginals (one masked forward per position, batched over
positions), pseudo-ppl (a masked scan of each mutant sequence); the MSA
Transformer masks positions of the MSA's first row only. Same flags and the
same output as the JAX CLI: the input CSV with one score column per model,
written with its unnamed index column first, as pandas' ``to_csv`` writes it.
The CSV is read and written with the ``csv`` module (no pandas).
Masked-marginals runs only the positions the scan mutates: the scores are
those of a run over every position. Log-softmax runs in fp32.

Runs on the GPU; --nogpu runs on the CPU, and without a GPU the run raises
unless --nogpu is given; --int8 quantizes the linear layers' weights to
int8 (weight-only). Run it as
``python -m esm_tpu_torch.cli.predict_variants``.
"""

from __future__ import annotations

import argparse
import csv
import pathlib

import numpy as np
import torch


def create_parser():
    parser = argparse.ArgumentParser(
        description="Label a deep mutational scan with predictions from an ensemble of ESM models."
    )
    parser.add_argument(
        "--model-location", type=str, help="PyTorch model file OR name of pretrained model",
        nargs="+", required=True,
    )
    parser.add_argument("--sequence", type=str, help="wild-type protein sequence the DMS variants mutate")
    parser.add_argument("--dms-input", type=pathlib.Path, help="input CSV with one row per variant")
    parser.add_argument("--mutation-col", type=str, default="mutant", help="column with mutations (like P76A)")
    parser.add_argument("--dms-output", type=pathlib.Path, help="where to write the input CSV augmented with a score column per model")
    parser.add_argument("--offset-idx", type=int, default=0, help="index of the first residue in the mutation notation (e.g. 1 when P76A means sequence position 75)")
    parser.add_argument(
        "--scoring-strategy", type=str, default="wt-marginals",
        choices=["wt-marginals", "pseudo-ppl", "masked-marginals"],
    )
    parser.add_argument("--msa-path", type=pathlib.Path, help="a3m alignment to subsample (MSA Transformer scoring only)")
    parser.add_argument("--msa-samples", type=int, default=400, help="number of sequences from the start of the MSA")
    parser.add_argument("--mask-batch", type=int, default=64, help="positions scored per device batch (masked-marginals)")
    parser.add_argument("--msa-mask-batch", type=int, default=8, help="positions per device batch for the MSA Transformer (each position replicates the whole MSA)")
    parser.add_argument("--nogpu", action="store_true", help="run on the host CPU even when a GPU is present")
    parser.add_argument(
        "--eval-column", type=str, default=None,
        help="DMS measurement column: after scoring, print each model's "
        "|spearman rho| against it (and the ensemble's, with multiple models)",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="weight-only int8 quantization of the linear layers",
    )
    return parser


def _parse(mutation: str, offset_idx: int, sequence: str):
    """'P76A' -> ('P', 0-based residue index, 'A'); the wild type must match
    the sequence."""
    wt, idx, mt = mutation[0], int(mutation[1:-1]) - offset_idx, mutation[-1]
    if not 0 <= idx < len(sequence) or sequence[idx] != wt:
        raise ValueError(f"{mutation}: the listed wildtype does not match the provided sequence")
    return wt, idx, mt


def wt_marginal_score(token_probs, idx, wt_enc, mt_enc, prepend_bos=1):
    """score = logp[mt] - logp[wt] at 0-based residue ``idx`` of one
    sequence's (T, V) log-probs (reference predict.py:107-115). The
    arithmetic of ``label_row`` and of the server's /score endpoint."""
    return float(
        token_probs[prepend_bos + idx, mt_enc]
        - token_probs[prepend_bos + idx, wt_enc]
    )


def label_row(row, sequence, token_probs, alphabet, offset_idx):
    """score = logp[mt] - logp[wt] at the mutated residue of one sequence's
    (1, T, V) log-probs (reference predict.py:107-115)."""
    wt, idx, mt = _parse(row, offset_idx, sequence)
    return wt_marginal_score(token_probs[0], idx, alphabet.get_idx(wt), alphabet.get_idx(mt),
                             prepend_bos=1)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def masked_marginals(model, alphabet, tokens, mask_batch: int = 64, positions=None):
    """Masked-marginals batched over positions (reference predict.py:205-215):
    row k of a batch masks one position, in the MSA's first row for (1, R, C)
    MSA tokens (reference predict.py:161-178). Only ``positions`` (token
    indices; all by default) are run. Returns (1, T, V) fp32 numpy
    log-probs, NaN at positions not run."""
    t = tokens.shape[-1]
    positions = np.arange(t) if positions is None else np.asarray(positions)
    out = np.full((1, t, len(alphabet)), np.nan, dtype=np.float32)
    tokens = tokens.to(model.device)
    first_row = (0,) if tokens.dim() == 3 else ()
    for start in range(0, len(positions), mask_batch):
        idxs = torch.as_tensor(positions[start:start + mask_batch], device=model.device)
        at = (torch.arange(len(idxs), device=model.device), *first_row, idxs)
        batch = tokens.repeat(len(idxs), *[1] * (tokens.dim() - 1))
        batch[at] = alphabet.mask_idx
        logp = _log_softmax(model(batch)["logits"])
        out[0, idxs.cpu().numpy()] = logp[at].cpu().numpy()
    return out


def compute_pppl(row, sequence, model, alphabet, offset_idx, mask_batch: int = 64):
    """Pseudo-perplexity score of one mutant (reference predict.py:118-144),
    batched over positions; like the reference, token position i is scored
    against residue ``sequence[i]``."""
    wt, idx, mt = _parse(row, offset_idx, sequence)
    sequence = sequence[:idx] + mt + sequence[idx + 1:]
    _, _, tokens = alphabet.get_batch_converter()([("protein1", sequence)])
    tokens = tokens.to(model.device)
    positions = np.arange(1, len(sequence) - 1)
    total = 0.0
    for start in range(0, len(positions), mask_batch):
        idxs = positions[start:start + mask_batch]
        rows = torch.arange(len(idxs), device=model.device)
        cols = torch.as_tensor(idxs, device=model.device)
        want = torch.as_tensor([alphabet.get_idx(sequence[i]) for i in idxs],
                               device=model.device)
        batch = tokens.repeat(len(idxs), 1)
        batch[rows, cols] = alphabet.mask_idx
        logp = _log_softmax(model(batch)["logits"])
        for value in logp[rows, cols, want].cpu().numpy():
            total += float(value)
    return total


def read_msa(path, nseq):
    """The first ``nseq`` rows of an a3m, insertions (lower case, '.', '*')
    removed."""
    from ..data import read_msa as _read_msa

    return _read_msa(path)[:nseq]


def read_table(path):
    """A CSV as (column names, rows of strings); an empty header cell is named
    as pandas names it ("Unnamed: i")."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    header = [name or f"Unnamed: {i}" for i, name in enumerate(header)]
    return header, rows


def write_table(path, header, rows):
    """Rows under an unnamed index column, as pandas' ``to_csv`` writes a
    frame with its default index."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + list(header))
        for i, row in enumerate(rows):
            writer.writerow([i] + [repr(v) if isinstance(v, float) else v for v in row])


def _positions(mutations, offset_idx, sequence):
    """Token positions the scan mutates (bos first)."""
    return sorted({1 + _parse(m, offset_idx, sequence)[1] for m in mutations})


def run(args):
    from .. import pretrained
    from ..quantization import quantize_params

    device = pretrained.resolve_device("cpu" if args.nogpu else None)
    header, rows = read_table(args.dms_input)
    mutations = [r[header.index(args.mutation_col)] for r in rows]
    positions = _positions(mutations, args.offset_idx, args.sequence)
    scores = {}

    for model_location in args.model_location:
        model, alphabet = pretrained.load_model_and_alphabet(model_location, device=device)
        if args.int8:  # in place: the loaded weights are not needed in fp32
            quantize_params(model.model)
        batch_converter = alphabet.get_batch_converter()
        if model.kind == "msa":
            if args.scoring_strategy != "masked-marginals":
                raise ValueError("MSA Transformer only supports masked marginal strategy")
            _, _, tokens = batch_converter([read_msa(args.msa_path, args.msa_samples)])
            token_probs = masked_marginals(model, alphabet, tokens, args.msa_mask_batch,
                                           positions)
        else:
            _, _, tokens = batch_converter([("protein1", args.sequence)])
            if args.scoring_strategy == "wt-marginals":
                token_probs = _log_softmax(model(tokens)["logits"]).cpu().numpy()
            elif args.scoring_strategy == "masked-marginals":
                token_probs = masked_marginals(model, alphabet, tokens, args.mask_batch,
                                               positions)
            else:
                scores[model_location] = [
                    compute_pppl(m, args.sequence, model, alphabet, args.offset_idx,
                                 args.mask_batch)
                    for m in mutations
                ]
                continue
        scores[model_location] = [
            label_row(m, args.sequence, token_probs, alphabet, args.offset_idx)
            for m in mutations
        ]

    header = header + [m for m in args.model_location if m not in header]
    table = [dict(zip(header, r)) for r in rows]
    for name, values in scores.items():
        for entry, value in zip(table, values):
            entry[name] = value
    write_table(args.dms_output, header, [[e[c] for c in header] for e in table])

    if args.eval_column:
        # |spearman rho| between each model's scores and a measurement column
        # (the reference's zero-shot evaluation, examples/variant-prediction/README.md)
        from ..metrics import spearman

        if args.eval_column not in header:
            raise SystemExit(f"--eval-column {args.eval_column!r} not in {args.dms_input}")
        target = np.asarray([float(e[args.eval_column]) for e in table])
        for model_location in args.model_location:
            rho = spearman(scores[model_location], target)
            print(f"{model_location}: |rho| vs {args.eval_column} = {abs(rho):.4f}")
        if len(args.model_location) > 1:
            ens = np.mean([scores[m] for m in args.model_location], axis=0)
            rho = spearman(ens, target)
            print(f"ensemble({len(args.model_location)}): |rho| = {abs(rho):.4f}")


def main():
    run(create_parser().parse_args())


if __name__ == "__main__":
    main()
