"""K6's share of its roofline in the traced folds: the sum of each call's
least time (``counts.attention.k6`` at (1, L, L, pair heads, head width))
over K6's summed device time. Silent unless the program's launch counter
shows two calls a trunk block a pass for every traced fold."""

from benchmark.counts import attention


def read(ctx):
    tc, tr, L = ctx.cell.config["trunk"], ctx.trace, ctx.cell.traffic["length"]
    calls = 2 * tc["num_blocks"] * tc["max_recycles"] * tr.items
    if not calls or tr.counters.get("k6") != calls:
        return None
    heads = tc["pairwise_state_dim"] // tc["pairwise_head_width"]
    bound = calls * attention.bound_s(*attention.k6(1, L, L, heads, tc["pairwise_head_width"]))
    spent = tr.kernel_s("tri_attn")
    return 100.0 * bound / spent if spent > 0 else None
