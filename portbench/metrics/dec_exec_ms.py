"""Milliseconds of the program's fenced span ``dec.fused_exec`` (the ring or
wide decoder) per whole-archive decode call."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "decode", "dec.fused_exec")
