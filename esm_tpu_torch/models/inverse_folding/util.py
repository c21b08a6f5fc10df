"""Inverse-folding geometry helpers, coordinate batches and structure loading.

Port of esm_tpu/models/inverse_folding/util.py (reference semantics:
esm/inverse_folding/util.py:145-323): ``rotate``, ``get_rotation_frames``
(Gram-Schmidt on N/CA/C), ``nan_to_num``, ``rbf``, ``norm``, ``normalize``,
and ``CoordBatchConverter`` (an inf bos/eos residue, NaN batch padding,
confidence padded with -1, ``<cath>`` as the begin token). Structures are
read without biotite, through the port's own reader (data/pdb.py), as the
JAX package does when biotite is absent (its util.py:176-191).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...data.alphabet import BatchConverter
from ...data.pdb import PDBAtoms, backbone_coords, read_structure


def nan_to_num(ts: torch.Tensor, val: float = 0.0) -> torch.Tensor:
    """Non-finite entries (NaN and +-inf) -> ``val``."""
    return torch.where(torch.isfinite(ts), ts, torch.full_like(ts, val))


def rbf(values: torch.Tensor, v_min: float, v_max: float, n_bins: int = 16) -> torch.Tensor:
    """Radial basis encoding appended as a trailing dim."""
    centers = torch.linspace(v_min, v_max, n_bins, device=values.device, dtype=values.dtype)
    std = (v_max - v_min) / n_bins
    z = (values[..., None] - centers) / std
    return torch.exp(-(z ** 2))


def norm(t: torch.Tensor, dim, eps: float = 1e-8, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(t), dim=dim, keepdim=keepdim) + eps)


def normalize(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return nan_to_num(t / norm(t, dim=dim, keepdim=True))


def rotate(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v: (..., C, 3), R: (..., 3, 3) -> v @ R per channel
    (reference util.py:145-158: sum(v[..., None] * R[..., None, :, :], -2))."""
    return torch.sum(v[..., None] * R[..., None, :, :], dim=-2)


def get_rotation_frames(coords: torch.Tensor) -> torch.Tensor:
    """Local frames from N/CA/C by Gram-Schmidt (reference util.py:161-179).
    coords: (B, L, 3, 3); returns (B, L, 3, 3) with rows e1, e2, e3."""
    v1 = coords[:, :, 2] - coords[:, :, 1]
    v2 = coords[:, :, 0] - coords[:, :, 1]
    e1 = normalize(v1, dim=-1)
    u2 = v2 - e1 * torch.sum(e1 * v2, dim=-1, keepdim=True)
    e2 = normalize(u2, dim=-1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-2)


class CoordBatchConverter(BatchConverter):
    """(coords, confidence, seq) batches -> (coords (B, T, 3, 3), confidence
    (B, T), strs, tokens (B, T'), padding_mask (B, T)) tensors
    (reference util.py:220-295). Coordinates get an inf bos/eos residue and
    NaN padding; ``padding_mask`` marks the NaN rows (missing residues
    included, as in the reference), and confidence is -1 wherever a residue
    lacks coordinates. Sets the alphabet's ``cls_idx`` to ``<cath>``, as the
    reference does."""

    def __call__(self, raw_batch: Sequence[Tuple], device=None):
        self.alphabet.cls_idx = self.alphabet.get_idx("<cath>")
        batch = []
        for coords, confidence, seq in raw_batch:
            if confidence is None:
                confidence = 1.0
            if isinstance(confidence, (float, int)):
                confidence = [float(confidence)] * len(coords)
            if seq is None:
                seq = "X" * len(coords)
            batch.append(((coords, confidence), seq))

        coords_and_confidence, strs, tokens = super().__call__(batch)

        coords_list = [
            np.pad(np.asarray(cd, np.float32), ((1, 1), (0, 0), (0, 0)),
                   constant_values=np.inf)
            for cd, _ in coords_and_confidence
        ]
        conf_list = [
            np.pad(np.asarray(cf, np.float32), (1, 1), constant_values=-1.0)
            for _, cf in coords_and_confidence
        ]
        max_len = max(c.shape[0] for c in coords_list)
        coords = np.full((len(batch), max_len, 3, 3), np.nan, np.float32)
        confidence = np.full((len(batch), max_len), -1.0, np.float32)
        for i, (c, f) in enumerate(zip(coords_list, conf_list)):
            coords[i, : c.shape[0]] = c
            confidence[i, : f.shape[0]] = f

        padding_mask = np.isnan(coords[:, :, 0, 0])
        coord_mask = np.isfinite(coords.sum(axis=(-2, -1)))
        confidence = confidence * coord_mask + (-1.0) * padding_mask
        out = [torch.from_numpy(coords), torch.from_numpy(confidence.astype(np.float32)),
               tokens, torch.from_numpy(padding_mask)]
        if device is not None:
            out = [t.to(device) for t in out]
        coords, confidence, tokens, padding_mask = out
        return coords, confidence, strs, tokens, padding_mask

    def from_lists(self, coords_list, confidence_list=None, seq_list=None, device=None):
        n = len(coords_list)
        if confidence_list is None:
            confidence_list = [None] * n
        if seq_list is None:
            seq_list = [None] * n
        return self(list(zip(coords_list, confidence_list, seq_list)), device=device)


def load_structure(fpath: str, chain=None) -> PDBAtoms:
    """Model 1 of a .pdb or .cif file, restricted to ``chain`` (an id, a list
    of ids, or None for all). Raises when the file has no chain or lacks a
    requested one (reference util.py:27-64)."""
    atoms = read_structure(fpath)
    all_chains = list(dict.fromkeys(atoms.chain_id))
    if not all_chains:
        raise ValueError("No chains found in the input file.")
    if chain is None:
        chain_ids = all_chains
    elif isinstance(chain, list):
        chain_ids = chain
    else:
        chain_ids = [chain]
    for c in chain_ids:
        if c not in all_chains:
            raise ValueError(f"Chain {c} not found in input file")
    return atoms[np.isin(atoms.chain_id, np.asarray(chain_ids, object))]


def extract_coords_from_structure(atoms: PDBAtoms) -> Tuple[np.ndarray, str]:
    """Atoms -> (L, 3, 3) N/CA/C coordinates (NaN where an atom is missing)
    and the one-letter sequence (reference util.py:66-76, 96-105)."""
    return backbone_coords(atoms)


def load_coords(fpath: str, chain: Optional[object]) -> Tuple[np.ndarray, str]:
    """(coords (L, 3, 3), native sequence) of ``chain`` (an id, a list of
    ids, or None for every chain) in a .pdb or .cif file."""
    atoms = read_structure(fpath)
    if isinstance(chain, list):
        return backbone_coords(atoms[np.isin(atoms.chain_id, np.asarray(chain, object))])
    return backbone_coords(atoms, chain=chain)
