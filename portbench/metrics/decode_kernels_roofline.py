"""The decode calls' least time on the card (the archive read once, the
output written once) over the time the card was busy inside them, in percent."""

from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "decode")
