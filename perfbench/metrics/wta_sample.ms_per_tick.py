"""Device ms of the WTA sampler kernel (``csrc/wta_sample.cu``:
``wta_sample_kernel``) in the traced stretch per decode tick there."""

from perfbench.trace import kernel_s


def read(ctx):
    t = kernel_s(ctx.stretch, "wta_sample_kernel")
    ticks = sum(1 for r in ctx.stretch_rows if r)
    return 1e3 * t / ticks if t and ticks else None
