"""Device milliseconds of collective operations per image completed in the
traced window, averaged over the cell's devices (device trace): the row
halo exchange and the sharded resize's boundary traffic."""

from perfbench import flops, trace as tr


def read(ctx):
    if ctx.trace is None or ctx.chips == 1:
        return None
    images = sum(r[2] for r in ctx.traced_requests()) \
        / flops.out_pixels(ctx.cell.config)
    if images == 0:
        return None
    ms = 1e3 * sum(tr.time_s(ctx.trace, d, tr.is_collective)
                   for d in range(ctx.chips)) / ctx.chips
    return ms / images if ms > 0 else None
