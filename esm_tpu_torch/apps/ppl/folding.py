"""Folding callbacks: sequence -> structure + confidence for energy terms.

Port of esm_tpu/apps/ppl/folding.py (reference semantics: examples/
protein-programming-language/language/folding_callbacks.py —
FoldingResult(ptm, plddt, atoms) from ESMFold).

:class:`ESMFoldCallback` folds with the port's ESMFold under
``torch.no_grad()`` (K6 refuses grad mode while the trunk's weights require
grad). Sequences are padded to a length bucket (a multiple of 16) with mask
0 on the padded rows, as esm_tpu pads them, so each fold runs at one of few
shapes; the residue indices are the program's (chain breaks skip 1000), not
``infer``'s offsets. Each fold reads back once: atom37 positions, existence,
pLDDT and pTM of the first L rows.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class AtomView:
    """Flat atom table (the subset of biotite's AtomArray the energies use)."""

    coord: np.ndarray      # (N, 3)
    atom_name: np.ndarray  # (N,) e.g. "CA"
    res_name: np.ndarray   # (N,) e.g. "LEU"
    res_id: np.ndarray     # (N,) residue indices (1-based, program numbering)
    element: np.ndarray    # (N,) e.g. "C"

    def __getitem__(self, mask) -> "AtomView":
        return AtomView(
            self.coord[mask],
            self.atom_name[mask],
            self.res_name[mask],
            self.res_id[mask],
            self.element[mask],
        )

    def __len__(self):
        return self.coord.shape[0]


@dataclass
class FoldingResult:
    ptm: float
    plddt: float
    atoms: AtomView
    residue_indices: np.ndarray


class FoldingCallback(ABC):
    @abstractmethod
    def fold(self, sequence: str, residue_indices: List[int]) -> FoldingResult: ...


def _round_up(n, m):
    return ((n + m - 1) // m) * m


class ESMFoldCallback(FoldingCallback):
    """Folds with the port's ESMFold (reference folding_callbacks.py:43-78).

    ``model`` is an ``ESMFoldHandle`` (its config's execution options apply:
    the fast preset runs K1 in the LM and K6 in the trunk), or an ``ESMFold``
    module with its ``cfg``."""

    def __init__(self, model, cfg=None, num_recycles: Optional[int] = 1, bucket: int = 16):
        if cfg is None:  # a handle
            cfg, model = model.cfg, model.model
        self.model = model
        self.cfg = cfg
        self.num_recycles = num_recycles
        self.bucket = bucket

    @torch.no_grad()
    def fold(self, sequence: str, residue_indices: List[int]) -> FoldingResult:
        from ...data import residue_constants as rc
        from ...models.esmfold import esmfold as ef
        from ...models.esmfold.protein import atom14_to_atom37

        L = len(sequence)
        padded = _round_up(L, self.bucket)
        aatype, mask, _residx, _, _ = ef.batch_encode_sequences(
            [sequence], residue_index_offset=None, chain_linker=""
        )
        pad = padded - aatype.shape[1]
        if pad:
            aatype = np.pad(aatype, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        residx = np.zeros((1, padded), np.int64)
        residx[0, :L] = np.asarray(residue_indices, np.int64)

        dev = self.model.device
        out = ef.apply(
            self.model,
            self.cfg,
            torch.from_numpy(aatype).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            residx=torch.from_numpy(residx).to(dev),
            num_recycles=self.num_recycles,
            frugal=True,
        )
        parts = (atom14_to_atom37(out["positions"][-1], out["aatype"])[0, :L],  # (L, 37, 3)
                 out["atom37_atom_exists"][0, :L], out["plddt"][0, :L], out["ptm"][:1])
        # one readback: atom37 positions, existence, pLDDT and pTM
        flat = torch.cat([x.float().reshape(-1) for x in parts]).cpu().numpy()
        pos37, mask37, plddt37, ptm = np.split(flat, np.cumsum([x.numel() for x in parts])[:-1])
        pos37 = pos37.reshape(L, -1, 3)
        mask37 = mask37.reshape(L, -1)
        plddt37 = plddt37.reshape(L, -1)
        # CA-only residue mean (atom37 index 1), matching the reference
        # EsmFoldv1 callback's per-residue pLDDT
        mean_plddt = float(plddt37[:, 1].mean()) / 100.0

        atom_types = rc.atom_types()
        r3 = rc.restype_1to3()
        keep = mask37 >= 0.5
        res_i, atom_j = np.nonzero(keep)
        res3 = np.asarray([r3.get(a, "UNK") for a in sequence])
        names = np.asarray(atom_types)[atom_j]
        atoms = AtomView(
            pos37[res_i, atom_j].astype(np.float32),
            names,
            res3[res_i],
            np.asarray(residue_indices, np.int64)[res_i],
            np.asarray([n[0] for n in names]),
        )
        return FoldingResult(
            ptm=float(ptm[0]),
            plddt=mean_plddt,
            atoms=atoms,
            residue_indices=np.asarray(residue_indices),
        )
