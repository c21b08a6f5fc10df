"""Protein output utilities: atom14/atom37 bookkeeping, confidence metrics
and a PDB writer.

Port of esm_tpu/models/esmfold/protein.py (the openfold utilities the
reference uses, esm/esmfold/v1/esmfold.py:23-25: make_atom14_masks,
compute_tm, compute_predicted_aligned_error; esm/esmfold/v1/misc.py:93-116:
atom14_to_atom37 and the PDB writer; esm/esmfold/v1/categorical_mixture.py:
the pLDDT expectation). The PDB writer is host-side numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...data import residue_constants as rc
from .structure_module import table


def make_atom14_masks(aatype: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-residue atom14/atom37 index maps and existence masks."""
    return {
        "residx_atom14_to_atom37": table("restype_atom14_to_atom37", aatype),
        "residx_atom37_to_atom14": table("restype_atom37_to_atom14", aatype),
        "atom14_atom_exists": table("restype_atom14_mask", aatype),
        "atom37_atom_exists": table("restype_atom37_mask", aatype),
    }


def atom14_to_atom37(atom14: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
    """(..., L, 14, 3) -> (..., L, 37, 3)."""
    idx = table("restype_atom37_to_atom14", aatype)  # (..., L, 37)
    atom37 = torch.gather(atom14, -2, idx[..., None].expand(idx.shape + (3,)))
    return atom37 * table("restype_atom37_mask", aatype)[..., None]


def _bin_centers(max_bin: float, no_bins: int, device=None) -> torch.Tensor:
    boundaries = torch.linspace(0.0, max_bin, no_bins - 1, device=device)
    step = boundaries[1] - boundaries[0]
    centers = boundaries + step / 2
    return torch.cat([centers, (centers[-1] + step)[None]])


def compute_tm(
    logits: torch.Tensor,
    residue_weights: Optional[torch.Tensor] = None,
    max_bin: int = 31,
    no_bins: int = 64,
    eps: float = 1e-8,
    pair=None,
) -> torch.Tensor:
    """Predicted TM-score from pairwise error-bin logits (AF2 suppl. 1.9.7).
    logits (..., L, L, no_bins); residue_weights (..., L) (the mask). The
    effective residue count comes from the weights, which with 0/1 weights
    equals the reference's slicing to the true length. ``pair`` (the sharded
    fold): logits are this rank's rows (..., L/N, L, no_bins) and the
    weights 0/1; each rank takes its rows' maximum of the weighted
    per-alignment score, and the group its maximum: with 0/1 weights that
    is the score at the unsharded argmax, bit for bit (every row with a real
    column scores above 0, and a weight of 1 multiplies exactly)."""
    if residue_weights is None:
        residue_weights = logits.new_ones(logits.shape[:-2])
    centers = _bin_centers(max_bin, no_bins, device=logits.device)
    n = residue_weights.sum(-1, keepdim=True)
    d0 = 1.24 * (torch.clamp_min(n, 19) - 15) ** (1.0 / 3) - 1.8   # (..., 1)
    probs = torch.softmax(logits, dim=-1)
    tm_per_bin = 1.0 / (1 + centers ** 2 / d0[..., None] ** 2)      # (..., 1, no_bins)
    predicted_tm = (probs * tm_per_bin[..., None, :]).sum(-1)       # (..., L, L)
    normed = residue_weights / (eps + residue_weights.sum(-1, keepdim=True))
    per_alignment = (predicted_tm * normed[..., None, :]).sum(-1)   # (..., L)
    if pair is not None:
        from ...parallel.pair_sharding import all_reduce_max

        return all_reduce_max((per_alignment * pair.local(residue_weights, -1)).amax(-1), pair)
    best = (per_alignment * residue_weights).argmax(-1, keepdim=True)
    return torch.gather(per_alignment, -1, best)[..., 0]


def compute_predicted_aligned_error(
    logits: torch.Tensor, max_bin: int = 31, no_bins: int = 64
) -> Dict[str, torch.Tensor]:
    centers = _bin_centers(max_bin, no_bins, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    return {
        "aligned_confidence_probs": probs,
        "predicted_aligned_error": (probs * centers).sum(-1),
        "max_predicted_aligned_error": centers[-1],
    }


def categorical_lddt(logits: torch.Tensor, bins: int = 50) -> torch.Tensor:
    """Expectation of the binned pLDDT distribution
    (reference esm/esmfold/v1/categorical_mixture.py:8-43)."""
    edges = torch.linspace(0.0, 1.0, bins + 1, device=logits.device)
    v_bins = (edges[:-1] + edges[1:]) / 2
    return (torch.softmax(logits, dim=-1) * v_bins).sum(-1)


# ---------------------------------------------------------------------------
# PDB output (host side, numpy)
# ---------------------------------------------------------------------------

PDB_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def to_pdb(
    aatype: np.ndarray,          # (L,)
    atom_positions: np.ndarray,  # (L, 37, 3)
    atom_mask: np.ndarray,       # (L, 37)
    residue_index: np.ndarray,   # (L,)
    b_factors: np.ndarray,       # (L,) or (L, 37)
    chain_index: Optional[np.ndarray] = None,
) -> str:
    """Minimal standards-compliant PDB writer (ATOM/TER/END records). Fully
    masked residues (batch padding, multimer linkers) write nothing and do
    not drive the chain and TER logic."""
    restypes3 = [rc.restype_1to3()[r] for r in rc.restypes()] + ["UNK"]
    atom_names = rc.atom_types()
    if b_factors.ndim == 1:
        b_factors = np.tile(b_factors[:, None], (1, 37))
    if chain_index is None:
        chain_index = np.zeros_like(aatype)

    lines: List[str] = []
    atom_idx = 1
    prev_chain = None
    last_real = None  # (res3, chain, residue_index) of the last written residue
    for i in range(aatype.shape[0]):
        if atom_mask[i].max() < 0.5:
            continue
        ci = int(chain_index[i])
        res3 = restypes3[min(int(aatype[i]), 20)]
        if prev_chain is not None and ci != prev_chain:
            lines.append(f"TER   {atom_idx:>5}      {last_real[0]:>3} "
                         f"{PDB_CHAIN_IDS[last_real[1]]}{last_real[2]:>4}")
            atom_idx += 1
        prev_chain = ci
        for j, name in enumerate(atom_names):
            if atom_mask[i, j] < 0.5:
                continue
            x, y, z = atom_positions[i, j]
            name_f = name if len(name) == 4 else f" {name:<3}"
            lines.append(
                f"ATOM  {atom_idx:>5} {name_f}{'':1}{res3:>3} "
                f"{PDB_CHAIN_IDS[ci]}{int(residue_index[i]):>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.00:6.2f}{b_factors[i, j]:6.2f}"
                f"          {name[0]:>2}"
            )
            atom_idx += 1
        last_real = (res3, ci, int(residue_index[i]))
    if last_real is not None:
        lines.append(f"TER   {atom_idx:>5}      {last_real[0]:>3} "
                     f"{PDB_CHAIN_IDS[last_real[1]]}{last_real[2]:>4}")
    lines.append("END")
    lines.append("")
    return "\n".join(lines)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def output_to_pdb(output: Dict) -> List[str]:
    """Model output dict -> one PDB string per batch row
    (reference esm/esmfold/v1/misc.py:93-116)."""
    aatype = torch.as_tensor(output["aatype"])
    positions = torch.as_tensor(output["positions"])[-1]
    final_pos = _np(atom14_to_atom37(positions, aatype.to(positions.device)))
    aatype = _np(aatype)
    mask = _np(output["atom37_atom_exists"])
    residx = _np(output["residue_index"]) + 1
    plddt = _np(output["plddt"])
    chain_index = _np(output["chain_index"]) if "chain_index" in output else None
    return [
        to_pdb(aatype[i], final_pos[i], mask[i], residx[i], plddt[i],
               None if chain_index is None else chain_index[i])
        for i in range(aatype.shape[0])
    ]
