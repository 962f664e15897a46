"""The traffic generator: a mix (``traffic/<mix>.json``) names its kind of
loop, found by that name in ``kinds/<kind>.py``, and the kind reads the
mix's parameters and drives the program with one closed-loop client, a
round of work at a time.

Each call the client makes is a ``Call`` timed on the host clock from the
call to the last byte on the host. Every output is compared with the input
as it arrives (``reference.judge``); each archive the program writes is kept,
once per distinct content, for the plain decoder after the window.
"""

from __future__ import annotations

import contextlib
import importlib
import time

from .reference.judge import count_bad_bytes


class Call:
    __slots__ = ("kind", "seconds", "in_bytes", "out_bytes", "phases")

    def __init__(self, kind: str, in_bytes: int):
        self.kind = kind
        self.in_bytes = in_bytes
        self.out_bytes = 0
        self.seconds = 0.0
        self.phases = None


class Recorder:
    """Collects the calls of the current stretch of the run. ``profiling``
    wraps each call in a profiler range named ``portbench.<kind>``;
    ``phases`` (the program's ``phase_records``) is read per call when set."""

    def __init__(self):
        self.calls: list[Call] = []
        self.profiling = False
        self.phases: dict | None = None

    @contextlib.contextmanager
    def span(self, kind: str, in_bytes: int):
        call = Call(kind, in_bytes)
        if self.phases is not None:
            self.phases.clear()
        if self.profiling:
            import torch

            rng = torch.profiler.record_function(f"portbench.{kind}")
        else:
            rng = contextlib.nullcontext()
        with rng:
            t0 = time.perf_counter()
            yield call
            call.seconds = time.perf_counter() - t0
        if self.phases is not None:
            call.phases = dict(self.phases)
        self.calls.append(call)


class Loop:
    """One mix on one configuration. ``round()`` runs one unit of traffic;
    ``tally`` holds the counts compared against the input so far."""

    def __init__(self, zt, cfg: dict, mix: dict, data: bytes, seed: int, device, rec: Recorder):
        self.zt = zt
        self.cfg = cfg
        self.mix = mix
        self.data = data
        self.seed = seed
        self.device = device
        self.rec = rec
        if cfg["seek_table_format"] != "foot":
            raise ValueError("the reference reads the Foot seek table only")
        self.fmt = zt.Format.FOOT
        self.archives: list[bytes] = []
        self.tally = {"bad_bytes": 0}

    def keep_archive(self, arc: bytes) -> None:
        if not any(arc == a for a in self.archives):
            self.archives.append(arc)

    def compare(self, got: bytes, lo: int, hi: int) -> None:
        self.tally["bad_bytes"] += count_bad_bytes(got, self.data[lo:hi])

    def warm(self) -> None:
        self.round()

    def close(self) -> None:
        pass


def make(zt, cfg, mix, data, seed, device, rec) -> Loop:
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    return kind.Loop(zt, cfg, mix, data, seed, device, rec)
