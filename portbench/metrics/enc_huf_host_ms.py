"""Milliseconds of the program's range ``zk.enc.host_decisions.huf`` (the
host's Huffman decisions, the second loop of ``archive._host_jobs``) less
the program's ranges inside it, per encode call, in the profiled stretch."""

from portbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "encode", "enc.host_decisions.huf", own=True)
