"""Milliseconds of the program's fenced span ``enc.parse_dispatch`` (the match
kernel at level 1, the parallel parse and the reach kernels above it) per
encode call."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "encode", "enc.parse_dispatch")
