"""setup_s: seconds from the process start to the window's start (data
from the seed, imports, the kernels' libraries, one warm operation)."""


def read(ctx):
    return ctx.setup_s
