"""Input MiB of every encode call in the window over the summed seconds of
those whole calls, each from the call to the archive's bytes on the host."""

from portbench.readers import rate_MiBps


def read(ctx):
    return rate_MiBps(ctx, "encode", "in_bytes")
