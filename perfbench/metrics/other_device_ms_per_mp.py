"""Device milliseconds per output megapixel of every operation that is
neither the conv kernel, nor a copy between host and device, nor a
collective: colour, resize, the conv3 epilogue, merge and relayouts, summed
over the cell's devices (device trace)."""

from perfbench import trace as tr


def _other(name):
    return not (tr.is_kernel(name) or tr.is_copy(name)
                or tr.is_collective(name))


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    px = sum(r[2] for r in ctx.traced_requests())
    if px == 0:
        return None
    ms = 1e3 * sum(tr.time_s(ctx.trace, d, _other) for d in range(ctx.chips))
    return ms / (px / 1e6)
