"""Host ms a decode step, the step ending in its tokens' read to the host
(``ServingMetrics.decode_time / decode_steps`` over the window)."""


def read(ctx):
    c = ctx.counters
    return 1e3 * c["decode_time"] / c["decode_steps"] if c["decode_steps"] else None
