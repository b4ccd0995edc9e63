"""Median request latency over every request of the window (host clock)."""

from perfbench import stats


def read(ctx):
    return stats.latency_ms(ctx.requests, 50)
