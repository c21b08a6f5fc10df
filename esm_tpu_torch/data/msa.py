"""MSA reading and diversity-based subsampling, numpy only.

The port's own copy of esm_tpu/data/msa.py (the port imports nothing of
esm_tpu): a3m reading with the insertion states removed, and the greedy
selector that picks a diverse subsample of an MSA (the reference notebook's
``greedy_select``, examples/contact_prediction.ipynb, without scipy).
"""

from __future__ import annotations

import string
from typing import List, Tuple

import numpy as np

# a3m insertion states: lowercase residues (insertions relative to the query)
# and "." padding; "*" terminates some tools' sequences. All are removed so
# every row aligns to the query columns (reference notebook `remove_insertions`).
_DELETE = str.maketrans("", "", string.ascii_lowercase + ".*")


def remove_insertions(sequence: str) -> str:
    """Drop lowercase/./* insertion characters from an aligned sequence."""
    return sequence.translate(_DELETE)


def read_msa(path) -> List[Tuple[str, str]]:
    """Read an MSA (a3m/aligned fasta) as [(label, seq)], insertions removed."""
    from .fasta import read_fasta

    return [(desc, remove_insertions(seq)) for desc, seq in read_fasta(path)]


def greedy_select(
    msa: List[Tuple[str, str]], num_seqs: int, mode: str = "max"
) -> List[Tuple[str, str]]:
    """Greedy diversity-maximizing (or -minimizing) MSA subsample.

    Seeds with row 0 (the query), then repeatedly adds the candidate whose
    mean hamming distance to the selected set is largest (``mode="max"``;
    smallest for ``"min"``), breaking ties toward the earliest row. Returns
    the chosen rows in their original MSA order. Implements the selection
    criterion of the reference notebook's ``greedy_select``
    (examples/contact_prediction.ipynb) without scipy.

    Tie-breaking is deterministic here (earliest remaining row wins). The
    reference accumulates float distances, so on exact mean-hamming ties
    (e.g. duplicate MSA rows) its float summation order picks an effectively
    arbitrary candidate — subsamples can differ from a reference-notebook
    reproduction at tied candidates, though the distance profile of the
    selected set is identical. See PARITY.md ("MSA subsampling").
    """
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    if len(msa) <= num_seqs:
        return list(msa)

    rows = np.array([list(seq) for _, seq in msa], dtype="S1").view(np.uint8)
    n, L = rows.shape

    selected = np.zeros(n, dtype=bool)
    selected[0] = True
    order = [0]
    # Running INTEGER sum of per-column mismatches from every row to the
    # selected set. The mean hamming distance is dist_sum / (L·|selected|),
    # whose divisor is candidate-independent — so arg-extremizing dist_sum is
    # exact (no float accumulation-order ties). Selected rows are masked out,
    # which keeps the earliest-remaining-row tie-break.
    dist_sum = np.zeros(n, dtype=np.int64)
    bad = np.iinfo(np.int64).min if mode == "max" else np.iinfo(np.int64).max
    pick = np.argmax if mode == "max" else np.argmin

    for _ in range(num_seqs - 1):
        dist_sum += np.count_nonzero(rows != rows[order[-1]], axis=1)
        idx = int(pick(np.where(selected, bad, dist_sum)))
        selected[idx] = True
        order.append(idx)

    return [msa[i] for i in np.flatnonzero(selected)]
