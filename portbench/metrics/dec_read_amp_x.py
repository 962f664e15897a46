"""Bytes the Decoder decoded per byte its reads returned: the program's
counters ``dec.frame_load_bytes`` (the frames it loaded) over
``dec.read_bytes``. A read served from the frame the Decoder holds adds
none; one that loads a frame for a page adds the frame."""

from portbench.ranges import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "decode", "dec.frame_load_bytes", "dec.read_bytes")
