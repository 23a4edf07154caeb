"""``setup_s``: seconds from the process's start to the window's, the
graph, the program's preparation, the kernels' builds on a first run,
the seed's weights and the first steps included (host clock)."""


def read(ctx):
    return ctx.setup_s
