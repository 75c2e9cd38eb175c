"""Device time of the paged prefill attention kernels
(``csrc/prefill_attention.cu``: ``prefill_tc_kernel``,
``paged_prefill_kernel``) in the traced stretch against the bound of its
chunks (keys and values of each chunk's context once, causal FLOPs), in %."""

from perfbench.trace import kernel_s


def read(ctx):
    m, rf = ctx.mcfg, ctx.roofline
    t = kernel_s(ctx.stretch, "prefill_tc_kernel", "paged_prefill_kernel")
    if not t or not ctx.stretch_chunks:
        return None
    bound = sum(rf.bound_s(*rf.prefill_attention(q0, n, m.n_layers, m.n_heads, m.n_kv_heads,
                                                 m.head_dim)) for _, q0, n, _ in ctx.stretch_chunks)
    return 100.0 * bound / t
