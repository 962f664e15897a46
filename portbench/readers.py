"""What the metric readers share. Each ``metrics/<name>.py`` is one
``read(ctx)`` that names its kind of call (``encode``, ``decode``) or the
program's phase; these take the number from the run's context ``ctx``:

- ``calls``: the window's calls (``driver.Call``), timed on the host clock;
- ``phases``: the calls of the fenced stretch, each with the program's
  ``phase_records`` (seconds by phase name);
- ``trace`` and ``traced``: the profiler's trace and the calls inside it;
- ``setup_s`` and ``device_kind``.

A reader that finds nothing to read returns ``None``, and the metric is
left out of the result line."""

from __future__ import annotations

from portbench.peaks import hbm_bytes_per_s


def rate_MiBps(ctx, kind: str, field: str):
    """MiB of ``field`` (``in_bytes`` or ``out_bytes``) of every call of
    ``kind`` in the window over the summed seconds of those calls."""
    calls = [c for c in ctx.calls if c.kind == kind]
    if not calls:
        return None
    return sum(getattr(c, field) for c in calls) / 2**20 / sum(c.seconds for c in calls)


def span_ms(ctx, kind: str, phase: str):
    """Milliseconds of the program's fenced span ``phase`` per call of
    ``kind`` that ran it."""
    calls = [c for c in ctx.phases if c.kind == kind and phase in c.phases]
    if not calls:
        return None
    return 1e3 * sum(c.phases[phase] for c in calls) / len(calls)


def idle_pct(ctx, kind: str):
    """Share of the wall time of the calls of ``kind``, in the profiled
    stretch, in which nothing ran on the card (no kernel, copy or set)."""
    if ctx.trace is None:
        return None
    wall, busy, n = ctx.trace.kind(kind)
    if n == 0 or busy <= 0:
        return None
    return 100.0 * (wall - busy) / wall


def roofline_pct(ctx, kind: str):
    """The least time of the calls of ``kind`` on the card over the time it
    was busy inside them, in percent: the work itself (the input read once
    and the output written once) at the card's memory rate, against the
    union of kernel, copy and set intervals within the calls."""
    rate = hbm_bytes_per_s(ctx.device_kind)
    if ctx.trace is None or rate is None:
        return None
    _wall, busy, n = ctx.trace.kind(kind)
    calls = [c for c in ctx.traced if c.kind == kind]
    if n == 0 or busy <= 0 or len(calls) != n:
        return None
    return 100.0 * sum(c.in_bytes + c.out_bytes for c in calls) / rate / busy
