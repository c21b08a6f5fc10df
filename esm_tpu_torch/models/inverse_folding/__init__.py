from .init import init
from .model import (
    GVPTransformerConfig,
    GVPTransformerModel,
    IF1_SIZES,
    get_encoder_output,
    get_sequence_loss,
    sample,
    score_sequence,
)
from .util import CoordBatchConverter, load_coords, load_structure
