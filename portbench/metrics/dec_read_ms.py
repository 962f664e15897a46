"""Milliseconds of the program's range ``zk.dec.read`` (one ``Decoder.read``
or ``readinto`` call: the seek table's lookup, any frame loads, the bytes
served) per read call, wall time, in the profiled stretch."""

from portbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "decode", "dec.read")
