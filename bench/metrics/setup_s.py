"""setup_s: from the start of the process to the opening of the window:
imports, the kernels' build (or load), the weights drawn, the runner built
and warmed up."""


def read(ctx):
    return ctx.setup_s
