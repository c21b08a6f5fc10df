"""Device milliseconds a fold that ``aten::copy_`` took (its self device time
in the traced folds): the layout copies around the pair ops' einsums and
the dtype casts."""


def read(ctx):
    tr = ctx.trace
    if not tr.items or "aten::copy_" not in tr.ops:
        return None
    return 1000.0 * tr.ops["aten::copy_"] / tr.items
