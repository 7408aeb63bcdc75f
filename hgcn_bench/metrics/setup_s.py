"""setup_s: process start to the window's first timed request (host
clock): the graph, ``Engine.register``, the kernels' build or load,
the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
