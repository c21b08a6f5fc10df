"""The LM's share of the bf16 peak over the embedding window: the layers'
matrix products for the real residues (``counts.models.esm2_embed``) of the
batches dispatched after the traced stretch, over their host-clock time."""

from benchmark.counts import models, peaks
from benchmark.tracing import untraced


def read(ctx):
    lengths, seconds = untraced(ctx.window, ctx.window.info["lengths"])
    if not lengths:
        return None
    return 100.0 * models.esm2_embed(ctx.cell.config, lengths) / seconds / peaks.BF16_FLOPS
