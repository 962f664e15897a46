"""Milliseconds of the program's fenced span ``dec.plan`` (``plan.py``) per
whole-archive decode call."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "decode", "dec.plan")
