"""Busy decode slots over ``max_batch``, averaged over the window's decode
ticks (``ServingMetrics.occupancy_mean``), in %."""


def read(ctx):
    c = ctx.counters
    return 100.0 * c["occ_sum"] / c["decode_steps"] if c["decode_steps"] else None
