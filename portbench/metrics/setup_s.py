"""Seconds from the process's start to the first timed call: imports, the
card's context, the input made from the seed, the program's libraries and
one warm round at the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
