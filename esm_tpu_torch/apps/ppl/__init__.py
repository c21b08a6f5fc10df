"""The protein programming language (port of esm_tpu/apps/ppl): program
trees of sequence segments with energy terms, the seven recipes of the
reference, and simulated annealing over an ESMFold folding callback."""

from .energy import (
    EnergyTerm,
    MatchSecondaryStructure,
    MaximizeGlobularity,
    MaximizePLDDT,
    MaximizePTM,
    MaximizeSurfaceExposure,
    MinimizeCRmsd,
    MinimizeDRmsd,
    MinimizeSurfaceExposure,
    MinimizeSurfaceHydrophobics,
    SymmetryRing,
)
from .folding import ESMFoldCallback, FoldingCallback, FoldingResult
from .optimize import run_simulated_annealing
from .program import ProgramNode
from .programs import (
    fixed_backbone,
    free_hallucination,
    functional_site_scaffolding,
    secondary_structure,
    symmetric_binding,
    symmetric_monomer,
    symmetric_two_level_multimer,
)
from .sequence import (
    ConstantSequenceSegment,
    FixedLengthSequenceSegment,
    VariableLengthSequenceSegment,
)
from .utilities import (
    get_atomview_in_residue_range,
    pdb_file_to_atomview,
    sequence_from_atomview,
)
