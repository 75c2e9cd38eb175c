"""The model's FLOPs of the window's decode ticks (per decoding row: 2 a
weight its token multiplies by, the LM head included, and attention over
its context) over the decode steps' time at the H100's bf16 peak, in %."""


def read(ctx):
    c, rf = ctx.counters, ctx.roofline
    if not c["decode_time"]:
        return None
    flops = sum(rf.decode_flops(ctx.mcfg, rows) for rows in ctx.decode_rows if rows)
    return 100.0 * flops / (c["decode_time"] * rf.BF16_FLOPS_PER_S)
