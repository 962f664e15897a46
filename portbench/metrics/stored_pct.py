"""Bytes stored per byte of user data, in percent: the frames and the seek
table of every archive written in the window over its input."""


def read(ctx):
    calls = [c for c in ctx.calls if c.kind == "encode"]
    if not calls:
        return None
    return 100.0 * sum(c.out_bytes for c in calls) / sum(c.in_bytes for c in calls)
