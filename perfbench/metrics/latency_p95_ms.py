"""95th percentile of request latency over every request of the window
(host clock): submission to the output on the host."""

from perfbench import stats


def read(ctx):
    return stats.latency_ms(ctx.requests, 95)
