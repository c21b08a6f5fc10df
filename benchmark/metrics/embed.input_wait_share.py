"""Share of the embedding window in which the dispatching thread waited for
a tokenized batch (``runtime.PipelineStats.dispatch_wait_s``, the program's
own counter, over the pipeline's whole run)."""


def read(ctx):
    stats = ctx.window.info["stats"]
    return 100.0 * stats.dispatch_wait_s / stats.total_s if stats.total_s > 0 else None
