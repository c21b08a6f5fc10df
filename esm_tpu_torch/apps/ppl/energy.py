"""Port of esm_tpu/apps/ppl/energy.py, copied (host side, numpy).

Energy terms over folded structures.

Reference semantics: examples/protein-programming-language/language/energy.py —
pTM/pLDDT maximization, symmetry rings, surface hydrophobics/exposure,
globularity, template cRMSD/dRMSD, secondary structure matching. Geometry via
esm_tpu_torch.apps.ppl.geometry (numpy) instead of biotite.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np

from .folding import AtomView, FoldingResult
from .geometry import annotate_sse_ca, kabsch_superimpose, rmsd, sasa

_HYDROPHOBICS = {"VAL", "ILE", "LEU", "PHE", "MET", "TRP"}


class EnergyTerm(ABC):
    @abstractmethod
    def compute(self, node, folding_result: FoldingResult) -> float: ...


class MaximizePTM(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        return 1.0 - folding_result.ptm


class MaximizePLDDT(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        return 1.0 - folding_result.plddt


_BACKBONE_ATOMS = ("N", "CA", "C")


def _backbone(atoms: AtomView) -> AtomView:
    return atoms[np.isin(atoms.atom_name, _BACKBONE_ATOMS)]


def _node_atoms(node, atoms: AtomView) -> AtomView:
    """Atoms inside ``node``'s residue-index range."""
    start, end = node.get_residue_index_range()
    return atoms[(atoms.res_id >= start) & (atoms.res_id < end)]


def _condensed_dists(coords: np.ndarray) -> np.ndarray:
    """Upper-triangle (i<j) pairwise distances, pdist-style."""
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    return d[np.triu_indices(len(coords), k=1)]


def _protomer_centers(node, atoms: AtomView) -> np.ndarray:
    """(P, 3) backbone centers of mass, one per child of ``node`` — computed
    in one shot: a (P, N_bb) residue-range mask matrix against the backbone
    coordinates (each protomer is a contiguous res_id range)."""
    bb = _backbone(atoms)
    ranges = np.array([c.get_residue_index_range() for c in node.get_children()])
    inside = (bb.res_id >= ranges[:, :1]) & (bb.res_id < ranges[:, 1:])  # (P, N)
    return (inside @ bb.coord) / inside.sum(axis=1, keepdims=True)


class SymmetryRing(EnergyTerm):
    """Spread (std) of distances between protomer centers of mass — adjacent
    protomers around the ring by default, every pair with
    ``all_to_all_protomer_symmetry`` (reference energy.py:42-71 semantics)."""

    def __init__(self, all_to_all_protomer_symmetry: bool = False) -> None:
        self.all_to_all = all_to_all_protomer_symmetry

    def compute(self, node, folding_result: FoldingResult) -> float:
        centers = _protomer_centers(node, folding_result.atoms)
        if self.all_to_all:
            d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
            dists = d[np.triu_indices(len(centers), k=1)]
        else:  # ring: successive centers, wrapping around
            dists = np.linalg.norm(centers - np.roll(centers, 1, axis=0), axis=-1)
        return float(np.std(dists))


def hydrophobic_score(atoms: AtomView, start=None, end=None) -> float:
    """Fraction of hydrophobic atoms that are surface exposed
    (reference energy.py:113-145)."""
    hydrophobic = np.isin(atoms.res_name, list(_HYDROPHOBICS))
    if start is None and end is None:
        selection = np.ones_like(hydrophobic)
    else:
        start = 0 if start is None else start
        end = atoms.res_id.max() + 1 if end is None else end
        selection = (atoms.res_id >= start) & (atoms.res_id < end)
    surf = sasa(atoms.coord, atoms.element) > 0
    hydrophobic_surf = selection & hydrophobic & surf
    denom = (selection & hydrophobic).sum()
    return float(hydrophobic_surf.sum() / denom) if denom else 0.0


class MinimizeSurfaceHydrophobics(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        start, end = node.get_residue_index_range()
        return hydrophobic_score(folding_result.atoms, start, end)


def surface_ratio(atoms: AtomView, start: int, end: int) -> float:
    mask = (atoms.res_id >= start) & (atoms.res_id < end)
    surf = mask & (sasa(atoms.coord, atoms.element) > 0)
    return float(surf.sum() / max(mask.sum(), 1))


class MinimizeSurfaceExposure(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        start, end = node.get_residue_index_range()
        return surface_ratio(folding_result.atoms, start, end)


class MaximizeSurfaceExposure(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        start, end = node.get_residue_index_range()
        return 1.0 - surface_ratio(folding_result.atoms, start, end)


class MaximizeGlobularity(EnergyTerm):
    def compute(self, node, folding_result: FoldingResult) -> float:
        bb = _backbone(_node_atoms(node, folding_result.atoms)).coord
        return float(np.std(np.linalg.norm(bb - bb.mean(axis=0), axis=-1)))


class _TemplateTerm(EnergyTerm):
    """Shared template handling for the RMSD terms: optional backbone
    restriction on both sides, truncation to the common length."""

    def __init__(self, template: AtomView, backbone_only: bool = False) -> None:
        self.template = _backbone(template) if backbone_only else template
        self.backbone_only = backbone_only

    def _paired_coords(self, node, folding_result: FoldingResult):
        atoms = _node_atoms(node, folding_result.atoms)
        if self.backbone_only:
            atoms = _backbone(atoms)
        n = min(len(self.template), len(atoms))
        return self.template.coord[:n], atoms.coord[:n]


class MinimizeCRmsd(_TemplateTerm):
    """Coordinate RMSD to a template after Kabsch superposition."""

    def compute(self, node, folding_result: FoldingResult) -> float:
        ref, got = self._paired_coords(node, folding_result)
        return rmsd(ref, kabsch_superimpose(ref, got))


class MinimizeDRmsd(_TemplateTerm):
    """Distance-matrix RMSD to a template (superposition-free)."""

    def compute(self, node, folding_result: FoldingResult) -> float:
        ref, got = self._paired_coords(node, folding_result)
        return float(
            np.sqrt(((_condensed_dists(ref) - _condensed_dists(got)) ** 2).mean())
        )


class MatchSecondaryStructure(EnergyTerm):
    """Fraction of residues NOT matching the desired SSE ('a'/'b'/'c')."""

    def __init__(self, secondary_structure_element: str) -> None:
        self.sse = secondary_structure_element

    def compute(self, node, folding_result: FoldingResult) -> float:
        atoms = _node_atoms(node, folding_result.atoms)
        ca = atoms[atoms.atom_name == "CA"].coord
        return float(np.mean(annotate_sse_ca(ca) != self.sse))
