"""Share of the frames the Decoder's reads touched that the frame it held
served without a load, in percent: the program's counters
``dec.frame_hits`` over ``dec.frame_visits``."""

from portbench.ranges import counter_ratio


def read(ctx):
    share = counter_ratio(ctx, "decode", "dec.frame_hits", "dec.frame_visits")
    return None if share is None else 100.0 * share
