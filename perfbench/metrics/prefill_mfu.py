"""The model's FLOPs of the window's prefill chunks (2 a layer weight a
token, the LM head at a prompt's last token, causal attention) over the
ticks' time outside their decode steps at the H100's bf16 peak, in %."""


def read(ctx):
    c, rf = ctx.counters, ctx.roofline
    host = c["busy"] - c["decode_time"]
    if not ctx.prefill_chunks or host <= 0:
        return None
    flops = sum(rf.prefill_flops(ctx.mcfg, q0, n, q0 + n == b) for _, q0, n, b in ctx.prefill_chunks)
    return 100.0 * flops / (host * rf.BF16_FLOPS_PER_S)
