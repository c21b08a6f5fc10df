"""ESMFold on the port: model, trunk, structure module, outputs."""

from .esmfold import (
    FOLD_LENGTH_BUCKET,
    ESMFold,
    ESMFoldConfig,
    PAIR_OUTPUTS,
    apply,
    apply_sharded,
    auto_frugal,
    batch_encode_sequences,
    encode_sequence,
    gather_pair_outputs,
    infer,
    infer_pdb,
    infer_pdbs,
)
from .init import init_esmfold
from .protein import output_to_pdb
from .structure_module import StructureModuleConfig
from .trunk import FoldingTrunkConfig
