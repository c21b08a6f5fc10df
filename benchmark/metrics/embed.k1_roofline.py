"""K1's share of its roofline in the traced batches of the embedding window:
the sum of each call's least time (``counts.attention.k1`` at the batch's
padded shape) over K1's summed device time. Silent unless the program's
launch counter shows one K1 call a layer for every traced batch."""

from benchmark.counts import attention


def read(ctx):
    cfg, shapes, tr = ctx.cell.config, ctx.window.info["shapes"], ctx.trace
    layers, heads = cfg["num_layers"], cfg["attention_heads"]
    if not shapes or tr.counters.get("k1") != layers * len(shapes):
        return None
    d = cfg["embed_dim"] // heads
    bound = sum(layers * attention.bound_s(*attention.k1(b, heads, t, t, d)) for b, t in shapes)
    spent = tr.kernel_s("flash_fwd")
    return 100.0 * bound / spent if spent > 0 else None
