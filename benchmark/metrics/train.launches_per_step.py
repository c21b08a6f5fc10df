"""Device kernel events a training step, in the traced steps: what the host
has to launch a step."""


def read(ctx):
    return ctx.trace.events / ctx.trace.items if ctx.trace.items else None
