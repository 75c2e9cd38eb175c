"""Device time of the paged decode attention kernel
(``csrc/paged_attention.cu``: ``paged_decode_kernel_*``) in the traced
stretch against the bound of its ticks' decoding rows, each key and value
byte of their real contexts read once, in %."""

from perfbench.trace import kernel_s


def read(ctx):
    m, rf = ctx.mcfg, ctx.roofline
    t = kernel_s(ctx.stretch, "paged_decode_kernel")
    rows = [r for r in ctx.stretch_rows if r]
    if not t or not rows:
        return None
    bound = sum(rf.bound_s(*rf.decode_attention(r, m.n_layers, m.n_heads, m.n_kv_heads,
                                                m.head_dim)) for r in rows)
    return 100.0 * bound / t
