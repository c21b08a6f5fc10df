"""The training step's share of the bf16 peak over the window: the forward
and backward matrix products of every step completed
(``counts.models.esm2_train_step``; the remat recompute not counted), over
the host-clock time of the steps that ran after the traced stretch."""

from benchmark.counts import models, peaks
from benchmark.tracing import untraced


def read(ctx):
    p = ctx.cell.traffic
    flops = models.esm2_train_step(ctx.cell.config, p["batch"], p["length"])
    steps, seconds = untraced(ctx.window, ctx.window.info["steps"])
    return 100.0 * flops * steps / seconds / peaks.BF16_FLOPS
