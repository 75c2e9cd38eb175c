"""95th percentile of the time to first token, in ms from each request's
due time, over the requests due in the window before its traced stretch
(open loop).  It stands beside the end-to-end tail, which does not repeat
closely enough over runs to be bounded."""

from perfbench import common


def read(ctx):
    return common.percentile(ctx.ttft_ms, 95) if ctx.ttft_ms else None
