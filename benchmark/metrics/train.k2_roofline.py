"""K2's share of its roofline in the traced training steps: the sum of each
backward call's least time (``counts.attention.k2``) over the device time
of K2's kernels (the dq pass with its row dot, the dk/dv pass). Silent
unless the program's counters show one dq and one dk/dv pass a layer a step."""

from benchmark.counts import attention


def read(ctx):
    cfg, p, tr = ctx.cell.config, ctx.cell.traffic, ctx.trace
    calls = cfg["num_layers"] * tr.items
    if not calls or tr.counters.get("k2_dq") != calls or tr.counters.get("k2_dkv") != calls:
        return None
    heads, t = cfg["attention_heads"], p["length"]
    bound = calls * attention.bound_s(*attention.k2(p["batch"], heads, t, t,
                                                    cfg["embed_dim"] // heads))
    spent = tr.kernel_s("flash_dq", "flash_dkv", "row_dot")
    return 100.0 * bound / spent if spent > 0 else None
