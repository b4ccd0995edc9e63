"""Percent of the traced window in which no operation ran on a device,
averaged over the cell's devices (device trace)."""

from perfbench import trace as tr


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    return 100 * sum(tr.idle_share(ctx.trace, d)
                     for d in range(ctx.chips)) / ctx.chips
