"""The program's own ranges in the profiler's trace, and its host counters.

The port opens a profiler range ``zk.<name>`` for each of its phases
(``device.phase_timer``) and for the parts of a phase it names
(``device.trace_range``), while a ``torch.profiler`` records. The ranges
record as host operations, so the trace's ``cpu_ops`` hold them, and
``Trace.gaps`` names an idle gap by the range that covers most of it. A
range's parent is the range that holds it in time: the port opens its
ranges on one thread.

``counters`` (``device.counters`` of the port) is always on; the port in
this process is read where it has them, as ``run.load_libraries`` reads its
libraries. A reader returns ``None`` where the trace holds no such range or
the program keeps no such counter.
"""

from __future__ import annotations

import bisect
import sys

from portbench.trace import _merge

PREFIX = "zk."


def _ranges(trace) -> list[tuple[float, float, str]]:
    """The ``zk.`` ranges by start, a range before those it holds."""
    found = [(a, b, n[len(PREFIX):]) for a, b, n in trace.cpu_ops if n.startswith(PREFIX)]
    return sorted(found, key=lambda r: (r[0], -r[1]))


def own_us(ranges, i: int) -> float:
    """Microseconds of ``ranges[i]`` (ordered as ``_ranges`` orders them)
    that none of the ranges it holds covers."""
    a, b, _n = ranges[i]
    inner = []
    j = i + 1
    while j < len(ranges) and ranges[j][0] < b:
        c0, c1, _m = ranges[j]
        if c1 <= b:
            inner.append((c0, c1))
        j += 1
    return (b - a) - sum(c1 - c0 for c0, c1 in _merge(inner))


def range_ms(ctx, kind: str, name: str, own: bool = False):
    """Milliseconds of the program's range ``zk.<name>`` per call of
    ``kind`` in the profiled stretch: its wall time, or with ``own`` its
    time less what the program's ranges inside it cover."""
    if ctx.trace is None:
        return None
    calls = [(t0, t1) for t0, t1, k in ctx.trace.spans if k == kind]
    ranges = _ranges(ctx.trace)
    starts = [a for a, _b, _n in ranges]
    total, found = 0.0, False
    for t0, t1 in calls:
        i = bisect.bisect_left(starts, t0)
        while i < len(ranges) and ranges[i][0] < t1:
            a, b, n = ranges[i]
            if n == name and b <= t1:
                total += own_us(ranges, i) if own else b - a
                found = True
            i += 1
    if not found:
        return None
    return 1e-3 * total / len(calls)


def counters() -> dict | None:
    """The port's host counters (``device.counters``), or ``None`` where the
    program in this process keeps none."""
    dev = sys.modules.get("zeekstd_tpu_torch.device")
    found = getattr(dev, "counters", None)
    return found if isinstance(found, dict) else None


def counter_ratio(ctx, kind: str, num: str, den: str):
    """``counters[num] / counters[den]``, where the window holds calls of
    ``kind`` and the counters are there and ``den`` is not 0. The counters
    sum every call of the run (the warm round, the window, the traced and
    fenced stretches); each of a run's calls does the same work, so the
    ratio is the window's."""
    found = counters()
    if found is None or not any(c.kind == kind for c in ctx.calls):
        return None
    if not found.get(den) or num not in found:
        return None
    return found[num] / found[den]
