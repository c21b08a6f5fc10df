"""Minimal dependency-free PDB and mmCIF reader.

Port of esm_tpu/data/pdb.py (numpy only). The reference reads structures
with biotite (esm/inverse_folding/util.py:27-64); the port has no biotite
and reads them with this module: ATOM (optionally HETATM) records of model 1,
altloc '' or 'A', for inverse-folding backbone extraction
(models/inverse_folding/util.py, multichain.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import residue_constants as rc


@dataclass
class PDBAtoms:
    """Flat atom table for model 1 of a PDB file."""

    coord: np.ndarray      # (N, 3) float32
    atom_name: np.ndarray  # (N,) str, stripped, e.g. "CA"
    res_name: np.ndarray   # (N,) str, e.g. "LEU"
    res_id: np.ndarray     # (N,) int author residue numbers
    chain_id: np.ndarray   # (N,) str
    element: np.ndarray    # (N,) str
    hetero: np.ndarray     # (N,) bool (HETATM records)

    def __getitem__(self, mask) -> "PDBAtoms":
        return PDBAtoms(
            self.coord[mask], self.atom_name[mask], self.res_name[mask],
            self.res_id[mask], self.chain_id[mask], self.element[mask],
            self.hetero[mask],
        )

    def __len__(self) -> int:
        return self.coord.shape[0]


def read_pdb(path_or_text: str, keep_hetero: bool = False) -> PDBAtoms:
    """Parse model 1 ATOM (and optionally HETATM) records.

    Accepts a filesystem path or raw PDB text. Keeps altloc '' or 'A' only
    (biotite's default structure view). Fixed-column PDB format.
    """
    if "\n" in path_or_text:
        lines = path_or_text.splitlines()
    else:
        with open(path_or_text) as f:
            lines = f.read().splitlines()

    coords, names, resn, resi, chains, elems, het = [], [], [], [], [], [], []
    in_model = 0
    for ln in lines:
        rec = ln[:6]
        if rec.startswith("MODEL"):
            in_model += 1
            if in_model > 1:
                break
            continue
        if rec.startswith("ENDMDL"):
            break
        is_atom = rec == "ATOM  "
        is_het = rec == "HETATM"
        if not (is_atom or (keep_hetero and is_het)):
            continue
        altloc = ln[16]
        if altloc not in (" ", "A"):
            continue
        coords.append((float(ln[30:38]), float(ln[38:46]), float(ln[46:54])))
        names.append(ln[12:16].strip())
        resn.append(ln[17:20].strip())
        resi.append(int(ln[22:26]))
        chains.append(ln[21].strip())
        elems.append(ln[76:78].strip() if len(ln) >= 78 else ln[12:16].strip()[:1])
        het.append(is_het)

    return PDBAtoms(
        np.asarray(coords, np.float32).reshape(-1, 3),
        np.asarray(names, object),
        np.asarray(resn, object),
        np.asarray(resi, np.int64),
        np.asarray(chains, object),
        np.asarray(elems, object),
        np.asarray(het, bool),
    )


def _cif_tokens(line: str) -> list:
    """Split one mmCIF data row into values ('...'/"..." quoting honored)."""
    toks, i, n = [], 0, len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c in "'\"":
            # CIF quoting: the value ends at a matching quote FOLLOWED BY
            # whitespace/EOL — a bare quote inside the value is literal
            # (primed atom ids like "O5'" / 'C1"' are spec-legal)
            j = i + 1
            while True:
                j = line.find(c, j)
                if j < 0:  # unterminated quote: take the rest
                    j = n
                    break
                if j + 1 >= n or line[j + 1] in " \t":
                    break
                j += 1
            toks.append(line[i + 1 : j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            toks.append(line[i:j])
            i = j
    return toks


def read_cif(path_or_text: str, keep_hetero: bool = False) -> PDBAtoms:
    """Parse the ``_atom_site`` loop of an mmCIF file (model 1 only).

    Dependency-free counterpart of the reference's biotite cif path
    (esm/inverse_folding/util.py:27-43): auth_* identifiers preferred over
    label_* (biotite's default), altloc '.'/'?'/'A' kept.
    """
    if "\n" in path_or_text:
        lines = path_or_text.splitlines()
    else:
        with open(path_or_text) as f:
            lines = f.read().splitlines()

    # locate the _atom_site loop header
    tags: list = []
    row_start = None
    i = 0
    while i < len(lines):
        if lines[i].strip() == "loop_":
            j = i + 1
            hdr = []
            while j < len(lines) and lines[j].strip().startswith("_"):
                hdr.append(lines[j].strip().split()[0])
                j += 1
            if hdr and all(h.startswith("_atom_site.") for h in hdr):
                tags = [h[len("_atom_site.") :] for h in hdr]
                row_start = j
                break
            i = j
        else:
            i += 1
    if row_start is None:
        raise ValueError("no _atom_site loop found in mmCIF input")

    col = {t: k for k, t in enumerate(tags)}

    def pick(row, *names, default=None):
        for name in names:
            k = col.get(name)
            if k is not None and row[k] not in (".", "?"):
                return row[k]
        return default

    coords, names, resn, resi, chains, elems, het = [], [], [], [], [], [], []
    first_model = None
    for ln in lines[row_start:]:
        s = ln.strip()
        if not s or s.startswith("#"):
            break
        if s.startswith("_") or s.startswith("loop_") or s.startswith("data_"):
            break
        row = _cif_tokens(s)
        if len(row) < len(tags):
            continue
        group = pick(row, "group_PDB", default="ATOM")
        if group not in ("ATOM", "HETATM"):
            continue
        model = pick(row, "pdbx_PDB_model_num")
        if first_model is None:
            first_model = model
        elif model != first_model:
            break  # later models
        is_het = group == "HETATM"
        if is_het and not keep_hetero:
            continue
        alt = pick(row, "label_alt_id", default=".")
        if alt not in (".", "?", "A"):
            continue
        try:
            xyz = (
                float(pick(row, "Cartn_x")),
                float(pick(row, "Cartn_y")),
                float(pick(row, "Cartn_z")),
            )
        except (TypeError, ValueError):
            continue
        coords.append(xyz)
        names.append(pick(row, "auth_atom_id", "label_atom_id", default=""))
        resn.append(pick(row, "auth_comp_id", "label_comp_id", default=""))
        resi.append(int(pick(row, "auth_seq_id", "label_seq_id", default="0")))
        chains.append(pick(row, "auth_asym_id", "label_asym_id", default=""))
        elems.append(pick(row, "type_symbol", default=""))
        het.append(is_het)

    return PDBAtoms(
        np.asarray(coords, np.float32).reshape(-1, 3),
        np.asarray(names, object),
        np.asarray(resn, object),
        np.asarray(resi, np.int64),
        np.asarray(chains, object),
        np.asarray(elems, object),
        np.asarray(het, bool),
    )


def read_structure(path_or_text: str, keep_hetero: bool = False) -> PDBAtoms:
    """Dispatch on file extension (.cif/.mmcif -> mmCIF, else fixed-column
    PDB); raw text is sniffed for an ``_atom_site`` loop."""
    if "\n" in path_or_text:
        if "_atom_site." in path_or_text:
            return read_cif(path_or_text, keep_hetero=keep_hetero)
        return read_pdb(path_or_text, keep_hetero=keep_hetero)
    if path_or_text.endswith((".cif", ".mmcif")):
        return read_cif(path_or_text, keep_hetero=keep_hetero)
    return read_pdb(path_or_text, keep_hetero=keep_hetero)


def backbone_coords(
    atoms: PDBAtoms, chain: Optional[str] = None
) -> Tuple[np.ndarray, str]:
    """N/CA/C coordinates per residue plus the 1-letter sequence.

    Missing backbone atoms become NaN rows (matching the reference's
    inverse-folding convention, esm/inverse_folding/util.py:96-105).
    Returns (coords (L, 3, 3) float32, sequence str).
    """
    if chain is not None:
        atoms = atoms[atoms.chain_id == chain]
    atoms = atoms[~atoms.hetero]
    three_to_one = {v: k for k, v in rc.restype_1to3().items()}

    # residues in file order, keyed by (chain, res_id)
    order = []
    seen = {}
    for i in range(len(atoms)):
        key = (atoms.chain_id[i], int(atoms.res_id[i]))
        if key not in seen:
            seen[key] = len(order)
            order.append((key, atoms.res_name[i]))

    coords = np.full((len(order), 3, 3), np.nan, np.float32)
    slot = {"N": 0, "CA": 1, "C": 2}
    for i in range(len(atoms)):
        s = slot.get(atoms.atom_name[i])
        if s is None:
            continue
        ridx = seen[(atoms.chain_id[i], int(atoms.res_id[i]))]
        if np.isnan(coords[ridx, s, 0]):
            coords[ridx, s] = atoms.coord[i]

    seq = "".join(three_to_one.get(resname, "X") for _, resname in order)
    return coords, seq
