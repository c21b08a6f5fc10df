"""Template loading for PPL energy terms.

Port of esm_tpu/apps/ppl/utilities.py (reference: examples/
protein-programming-language/language/utilities.py, pdb_file_to_atomarray
via biotite). Structures are read by the port's own reader
(esm_tpu_torch/data/pdb.py); MinimizeCRmsd/MinimizeDRmsd take the returned
AtomView directly as their template.
"""

from __future__ import annotations

import numpy as np

from ...data import residue_constants as rc
from ...data.pdb import read_structure
from .folding import AtomView


def pdb_file_to_atomview(pdb_path_or_text: str, chain: str | None = None) -> AtomView:
    """Load model 1 ATOM records of a PDB/mmCIF file (or raw text) as the
    AtomView consumed by the template energies
    (reference utilities.py:14-15)."""
    atoms = read_structure(pdb_path_or_text)
    if chain is not None:
        atoms = atoms[atoms.chain_id == chain]
    return AtomView(
        coord=atoms.coord,
        atom_name=atoms.atom_name,
        res_name=atoms.res_name,
        res_id=atoms.res_id,
        element=atoms.element,
    )


def get_atomview_in_residue_range(atoms: AtomView, start: int, end: int) -> AtomView:
    """Residue slice [start, end) by author numbering
    (reference utilities.py:18-19)."""
    return atoms[np.logical_and(atoms.res_id >= start, atoms.res_id < end)]


def sequence_from_atomview(atoms: AtomView) -> str:
    """1-letter sequence in residue order (reference
    language/sequence.py sequence_from_atomarray)."""
    three_to_one = {v: k for k, v in rc.restype_1to3().items()}
    seen, seq = set(), []
    for i in range(len(atoms)):
        key = int(atoms.res_id[i])
        if key not in seen:
            seen.add(key)
            seq.append(three_to_one.get(str(atoms.res_name[i]), "X"))
    return "".join(seq)
