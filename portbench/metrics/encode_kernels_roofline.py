"""The encode calls' least time on the card (the input read once, the
archive written once) over the time the card was busy inside them, in percent."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "encode")
