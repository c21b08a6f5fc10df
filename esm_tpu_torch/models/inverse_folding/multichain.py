"""Inverse folding of one chain in a complex.

Port of esm_tpu/models/inverse_folding/multichain.py (reference semantics:
esm/inverse_folding/multichain_util.py): the target chain first, then each
other chain after 10 NaN spacer residues; the target is sampled or scored
conditioned on the whole complex, the other chains held as ``<pad>``
tokens. Chains are read with the port's structure reader (data/pdb.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ...data.alphabet import Alphabet
from ...data.pdb import PDBAtoms
from .model import GVPTransformerModel, get_sequence_loss, sample
from .util import extract_coords_from_structure, load_structure


def extract_coords_from_complex(atoms: PDBAtoms) -> Tuple[Dict, Dict]:
    """Atoms -> ({chain: (L, 3, 3) coords}, {chain: sequence}), chains in
    the order they first appear."""
    coords, seqs = {}, {}
    for chain_id in dict.fromkeys(atoms.chain_id):
        coords[chain_id], seqs[chain_id] = extract_coords_from_structure(
            atoms[atoms.chain_id == chain_id])
    return coords, seqs


def load_complex_coords(fpath: str, chains) -> Tuple[Dict, Dict]:
    return extract_coords_from_complex(load_structure(fpath, chains))


def _concatenate_coords(coords: Dict, target_chain_id, padding_length: int = 10) -> np.ndarray:
    """Target chain first, NaN spacers between chains
    (reference multichain_util.py:54-77)."""
    pad_coords = np.full((padding_length, 3, 3), np.nan, dtype=np.float32)
    coords_list = [coords[target_chain_id]]
    for chain_id in coords:
        if chain_id == target_chain_id:
            continue
        coords_list.append(pad_coords)
        coords_list.append(coords[chain_id])
    return np.concatenate(coords_list, axis=0)


def sample_sequence_in_complex(model: GVPTransformerModel, alphabet: Alphabet, coords: Dict,
                               target_chain_id, temperature: float = 1.0,
                               padding_length: int = 10, seed: int = 0) -> str:
    """(reference multichain_util.py:80-104)"""
    target_chain_len = coords[target_chain_id].shape[0]
    all_coords = _concatenate_coords(coords, target_chain_id, padding_length)
    padding_pattern = ["<pad>"] * all_coords.shape[0]
    for i in range(target_chain_len):
        padding_pattern[i] = "<mask>"
    sampled = sample(model, alphabet, all_coords, partial_seq=padding_pattern,
                     temperature=temperature, seed=seed)
    return sampled[:target_chain_len]


def score_sequence_in_complex(model: GVPTransformerModel, alphabet: Alphabet, coords: Dict,
                              target_chain_id, target_seq: str,
                              padding_length: int = 10) -> Tuple[float, float]:
    """(reference multichain_util.py:107-135)"""
    all_coords = _concatenate_coords(coords, target_chain_id, padding_length)
    loss, target_padding_mask = get_sequence_loss(model, alphabet, all_coords, target_seq)
    ll_fullseq = -np.sum(loss * ~target_padding_mask) / np.sum(~target_padding_mask)
    coord_mask = np.all(np.isfinite(coords[target_chain_id]), axis=(-1, -2))
    ll_withcoord = -np.sum(loss[: coord_mask.shape[0]] * coord_mask) / np.sum(coord_mask)
    return float(ll_fullseq), float(ll_withcoord)
