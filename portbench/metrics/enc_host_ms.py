"""Milliseconds of the program's fenced span ``enc.host_decisions`` (the host's
per-block decisions, ``archive._host_jobs``) per encode call."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "encode", "enc.host_decisions")
