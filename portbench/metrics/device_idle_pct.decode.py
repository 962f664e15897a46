"""Share of the whole-archive decode calls' wall time, in the profiled
stretch, in which nothing ran on the card, in percent."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "decode")
