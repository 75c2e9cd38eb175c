"""Share of the traced stretch of serving ticks in which no operation ran
on the device, in %."""


def read(ctx):
    s = ctx.stretch
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s and s["window_s"] else None
