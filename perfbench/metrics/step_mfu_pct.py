"""The whole step's share of the chips' bf16 dense peak (device trace):
16,064 operations per output pixel completed in the traced window, over
the window times the chips times the peak."""

from perfbench import flops


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    px = sum(r[2] for r in ctx.traced_requests())
    if px == 0:
        return None
    flop = px * flops.conv_flop_per_px(ctx.cell.config)
    return 100 * flop / (ctx.trace.window_s * ctx.chips
                         * ctx.peak["bf16_dense_flop_per_s"])
