"""Host ms of the ticks outside their decode steps (admission and the
eager prefill chunks) per 1000 prompt tokens computed, over the window."""


def read(ctx):
    c = ctx.counters
    if not c["prefill_tokens"]:
        return None
    return 1e3 * (c["busy"] - c["decode_time"]) / c["prefill_tokens"] * 1e3
