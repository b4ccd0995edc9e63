"""Set-up: from the start of the process to the first timed request
(host clock): imports, the frame pool, weights, loading or compiling every
program the window runs, and the warm-up."""


def read(ctx):
    return ctx.setup_s
