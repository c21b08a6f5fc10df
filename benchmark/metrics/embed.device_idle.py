"""Share of the traced embedding window in which no kernel ran on the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
