"""Output megapixels completed in the window over the window (host clock)."""

from perfbench import stats


def read(ctx):
    return stats.throughput_mps(ctx.requests)
