"""Milliseconds of the program's ranges ``zk.dec.frame_load`` (the streaming
Decoder reading and decoding one frame, ``decode.Decoder._load_frame``), wall
time summed per decode call, in the profiled stretch."""

from portbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "decode", "dec.frame_load")
