"""The conv kernel's share of its roofline (device trace).

The least time for the conv work of the output pixels completed in the
traced window -- 16,064 operations and 2 bytes per pixel, bound by compute
at the bf16 dense peak -- over the summed device time of the operations
named ``srcnn_conv12_q`` on all the cell's devices in that window.
"""

from perfbench import flops, trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    px = sum(r[2] for r in ctx.traced_requests())
    kernel_s = sum(tr.time_s(ctx.trace, d, tr.is_kernel)
                   for d in range(ctx.chips))
    if px == 0 or kernel_s == 0:
        return None
    cfg = ctx.cell.config
    least, _ = flops.least_time_s(px * flops.conv_flop_per_px(cfg),
                                  px * flops.conv_bytes_per_px(cfg), ctx.peak)
    return 100 * least / kernel_s
