"""Output MiB of every whole-archive decode call in the window over the
summed seconds of those calls, each to the last byte on the host."""

from portbench.readers import rate_MiBps


def read(ctx):
    return rate_MiBps(ctx, "decode", "out_bytes")
