"""Port of esm_tpu/apps/ppl/programs.py, copied (host side).

The reference's seven runnable design recipes as named program builders.

Reference: examples/protein-programming-language/programs/*.py — each function
returns the root ProgramNode of a design program; feed it to
``run_simulated_annealing`` with a folding callback. Where the reference
fetches a template structure from RCSB at import time
(functional_site_scaffolding / symmetric_binding), the builders here take a
pre-loaded ``AtomView`` + residue range instead — load it with
``pdb_file_to_atomview`` from a local file (this environment has no network;
the example scripts document the reference's PDB ids).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .energy import (
    MatchSecondaryStructure,
    MaximizeGlobularity,
    MaximizePLDDT,
    MaximizePTM,
    MaximizeSurfaceExposure,
    MinimizeCRmsd,
    MinimizeDRmsd,
    MinimizeSurfaceHydrophobics,
    SymmetryRing,
)
from .folding import AtomView
from .program import ProgramNode
from .sequence import (
    ConstantSequenceSegment,
    FixedLengthSequenceSegment,
    VariableLengthSequenceSegment,
)
from .utilities import get_atomview_in_residue_range, sequence_from_atomview


def free_hallucination(sequence_length: int) -> ProgramNode:
    """Hallucinate one confident, soluble monomer of the given length
    (reference programs/free_hallucination.py:16-24)."""
    return ProgramNode(
        sequence_segment=FixedLengthSequenceSegment(sequence_length),
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            MinimizeSurfaceHydrophobics(),
        ],
    )


def fixed_backbone(template: AtomView) -> ProgramNode:
    """Redesign the sequence of a known backbone: cRMSD/dRMSD to the template
    plus confidence terms (reference programs/fixed_backbone.py:14-39)."""
    sequence_length = len(sequence_from_atomview(template))
    return ProgramNode(
        sequence_segment=FixedLengthSequenceSegment(sequence_length),
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            MinimizeSurfaceHydrophobics(),
            MinimizeCRmsd(template=template, backbone_only=True),
            MinimizeDRmsd(template=template, backbone_only=True),
        ],
    )


def functional_site_scaffolding(
    site: AtomView,
    residue_range: Optional[Tuple[int, int]] = None,
    flank_length: int = 50,
) -> ProgramNode:
    """Scaffold a constant functional-site motif between two variable-length
    flanks, keeping the site surface-exposed and close to its native geometry
    (reference programs/functional_site_scaffolding.py:28-58, which uses the
    ACE2-binding site of PDB 6m0j residues 23-42).

    ``site`` is the motif structure (pass ``residue_range=(start, end)`` to
    slice it out of a larger chain first).
    """
    if residue_range is not None:
        site = get_atomview_in_residue_range(site, *residue_range)
    site_sequence = sequence_from_atomview(site)

    return ProgramNode(
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            MinimizeSurfaceHydrophobics(),
        ],
        children=[
            ProgramNode(sequence_segment=VariableLengthSequenceSegment(flank_length)),
            ProgramNode(
                sequence_segment=ConstantSequenceSegment(site_sequence),
                energy_function_terms=[
                    MaximizeSurfaceExposure(),
                    MinimizeCRmsd(template=site),
                    MinimizeDRmsd(template=site),
                ],
                energy_function_weights=[1.0, 10.0, 10.0],
            ),
            ProgramNode(sequence_segment=VariableLengthSequenceSegment(flank_length)),
        ],
    )


def secondary_structure(
    node1_sse: str = "a",
    node2_sse: str = "b",
    segment_length: int = 50,
) -> ProgramNode:
    """Hallucinate a two-segment protein while steering each segment's
    secondary structure — 'a' helix, 'b' strand, 'c' coil (reference
    programs/secondary_structure.py:16-47)."""
    segments = [
        ProgramNode(
            sequence_segment=FixedLengthSequenceSegment(segment_length),
            energy_function_terms=[MatchSecondaryStructure(sse)],
        )
        for sse in (node1_sse, node2_sse)
    ]
    return ProgramNode(
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            MinimizeSurfaceHydrophobics(),
        ],
        children=segments,
    )


def symmetric_monomer(num_protomers: int, protomer_length: int = 50) -> ProgramNode:
    """One chain of ``num_protomers`` identical repeats arranged in a
    symmetric ring (reference programs/symmetric_monomer.py:16-36). The
    protomer segment object is shared between the children, so every repeat
    mutates in lockstep."""
    protomer_sequence = FixedLengthSequenceSegment(protomer_length)
    return ProgramNode(
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            SymmetryRing(),
            MinimizeSurfaceHydrophobics(),
        ],
        children=[
            ProgramNode(sequence_segment=protomer_sequence)
            for _ in range(num_protomers)
        ],
    )


def symmetric_binding(
    site: AtomView,
    residue_range: Optional[Tuple[int, int]] = None,
    num_binding_sites: int = 3,
    flank_length: int = 45,
) -> ProgramNode:
    """A symmetric ring of identical binder protomers, each scaffolding the
    same constant binding-site motif (reference
    programs/symmetric_binding.py:28-65, which uses the IL-10 epitope of PDB
    1y6k residues 31-40). The three segment objects are shared across
    protomers, so the ring stays sequence-identical under mutation."""
    if residue_range is not None:
        site = get_atomview_in_residue_range(site, *residue_range)
    site_sequence = sequence_from_atomview(site)

    leader = FixedLengthSequenceSegment(flank_length)
    motif = ConstantSequenceSegment(site_sequence)
    follower = FixedLengthSequenceSegment(flank_length)

    def _binder_protomer_program() -> ProgramNode:
        return ProgramNode(
            children=[
                ProgramNode(sequence_segment=leader),
                ProgramNode(
                    sequence_segment=motif,
                    energy_function_terms=[
                        MaximizeSurfaceExposure(),
                        MinimizeCRmsd(template=site),
                        MinimizeDRmsd(template=site),
                    ],
                    energy_function_weights=[1.0, 10.0, 10.0],
                ),
                ProgramNode(sequence_segment=follower),
            ]
        )

    return ProgramNode(
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            SymmetryRing(),
            MinimizeSurfaceHydrophobics(),
        ],
        children=[_binder_protomer_program() for _ in range(num_binding_sites)],
    )


def symmetric_two_level_multimer(
    num_chains: int,
    num_protomers_per_chain: int,
    protomer_sequence_length: int = 50,
) -> ProgramNode:
    """Two-level symmetry: a shared protomer repeated into symmetric chains,
    and the chains arranged into a symmetric multimer (separate chains via
    the +1000 residue-index skip) — reference
    programs/symmetric_two_level_multimer.py:17-64."""
    protomer_sequence = FixedLengthSequenceSegment(protomer_sequence_length)

    def _make_chain_node() -> ProgramNode:
        return ProgramNode(
            energy_function_terms=[SymmetryRing(), MaximizeGlobularity()],
            energy_function_weights=[1.0, 0.05],
            children=[
                ProgramNode(sequence_segment=protomer_sequence)
                for _ in range(num_protomers_per_chain)
            ],
        )

    return ProgramNode(
        energy_function_terms=[
            MaximizePTM(),
            MaximizePLDDT(),
            SymmetryRing(),
            MinimizeSurfaceHydrophobics(),
        ],
        children=[_make_chain_node() for _ in range(num_chains)],
        children_are_different_chains=True,
    )
