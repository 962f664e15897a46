"""The device's side of a traced run, from ``torch.profiler``'s trace.

``profile(rounds)`` runs the rounds under the profiler (CPU and CUDA
activity) inside one range, ``portbench.window``, exports the trace to the
temporary directory, reads it and deletes it. The result holds:

- ``device``: the merged intervals in which a kernel, a copy or a set ran
  on the card, clipped to the window (microseconds on the trace's clock);
- ``spans``: the harness's own ranges ``portbench.<kind>`` around each call;
- ``ops``: device time by the profiler's operation name;
- ``cpu_ops``: the host operations, to say what the host did in a gap.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import warnings

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list[dict]):
        window = None
        spans, device, cpu_ops, ops = [], [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if cat == "user_annotation" and name.startswith("portbench."):
                if name == "portbench.window":
                    window = (t0, t1)
                else:
                    spans.append((t0, t1, name[len("portbench."):]))
            elif cat in DEVICE_CATS:
                device.append((t0, t1, name))
            elif cat == "cpu_op":
                cpu_ops.append((t0, t1, name))
        if window is None:
            raise RuntimeError("the profiler's trace holds no portbench.window range")
        self.window = window
        w0, w1 = window
        self.spans = sorted(s for s in spans if s[0] >= w0 and s[1] <= w1)
        clipped = sorted((max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1)
        for a, b, n in clipped:
            ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
        self.ops = ops
        self.device = _merge([(a, b) for a, b, _n in clipped])
        self._starts = [a for a, _b in self.device]
        self.cpu_ops = cpu_ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.device) * 1e-6

    def busy_in(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which the device ran something."""
        i = max(bisect.bisect_right(self._starts, t0) - 1, 0)
        busy = 0.0
        while i < len(self.device) and self.device[i][0] < t1:
            a, b = self.device[i]
            busy += max(0.0, min(b, t1) - max(a, t0))
            i += 1
        return busy * 1e-6

    def kind(self, kind: str) -> tuple[float, float, int]:
        """(wall seconds, device-busy seconds, calls) of the spans of ``kind``."""
        wall = busy = 0.0
        n = 0
        for t0, t1, k in self.spans:
            if k == kind:
                wall += (t1 - t0) * 1e-6
                busy += self.busy_in(t0, t1)
                n += 1
        return wall, busy, n

    def gaps(self, limit: int = 10) -> list[list]:
        """The longest stretches inside the harness's spans with nothing on
        the device, each named by its span and the host operation that
        covers most of it."""
        found = []
        for t0, t1, kind in self.spans:
            cur = t0
            i = max(bisect.bisect_right(self._starts, t0) - 1, 0)
            while i < len(self.device) and self.device[i][0] < t1:
                a, b = self.device[i]
                if a > cur:
                    found.append((a - cur, cur, a, kind))
                cur = max(cur, b)
                i += 1
            if t1 > cur:
                found.append((t1 - cur, cur, t1, kind))
        found.sort(reverse=True)
        out = []
        for length, g0, g1, kind in found[:limit]:
            # A host operation names the gap only where it covers most of it;
            # otherwise the host ran Python or native code outside torch.
            best, label = 0.5 * (g1 - g0), "host code outside torch ops"
            for a, b, name in self.cpu_ops:
                ov = min(b, g1) - max(a, g0)
                if ov > best:
                    best, label = ov, name
            out.append([f"{kind}: {label}", length * 1e-6])
        return out

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": self.gaps()}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile(run_rounds, warm) -> Trace:
    """Profile ``run_rounds()`` after ``warm()`` under the same profiler (its
    first use sets up the tracer), and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        # Its note that it keeps the events of one cycle: this profile has one.
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with torch.profiler.profile(activities=acts) as prof:
            warm()
            torch.cuda.synchronize()
            with record_function("portbench.window"):
                run_rounds()
                torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(), f"portbench-trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    return Trace(events)
