"""The fold's share of the bf16 peak over the window: the matrix products of
a fold (``counts.models.esmfold_fold``: the LM, every pass's trunk blocks and
structure module, the heads) times the folds that ran after the traced
stretch, over their host-clock time."""

from benchmark.counts import models, peaks
from benchmark.tracing import untraced


def read(ctx):
    flops = models.esmfold_fold(ctx.cell.config, ctx.cell.traffic["length"])
    folds, seconds = untraced(ctx.window, ctx.window.info["folds"])
    return 100.0 * flops * folds / seconds / peaks.BF16_FLOPS
