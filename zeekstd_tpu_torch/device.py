"""Device resolution and phase timing for the PyTorch port.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card they raise instead of continuing on the
CPU. ``phase_timer``/``phase_records`` keep the phase names of the JAX
package's accounting (``enc.parse_dispatch``, ``dec.fused_exec``, ...),
so the two packages' breakdowns compare line by line. Timing starts off
unless ``ZEEKSTD_TPU_TIMING`` is ``1`` (wall clock) or ``2`` (fenced) when
the package is imported; ``set_timing`` switches it at any time.

While a ``torch.profiler`` records, every phase is also a profiler range
``zk.<phase>`` on the trace's clock, beside the device's events, and
``trace_range`` adds ranges that are not phases (the loops of a phase, the
streaming layer's calls). ``counters`` counts host work, always on.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` (or a CPU device) runs the
    plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_reference_arrays(device=None, **arrays) -> dict[str, torch.Tensor]:
    """Stage numpy arrays of the reference's layouts (meta records, word
    tables, table pools, stat rows) as the port's tensors on ``device``.
    uint32 arrays keep their bits as int32."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(a.copy()).to(dev)
    return out


# Read once at import, as the reference reads ZEEKSTD_TPU_TIMING.
_TIMING = os.environ.get("ZEEKSTD_TPU_TIMING") in ("1", "2")
_FENCE = os.environ.get("ZEEKSTD_TPU_TIMING") == "2"

# Phase wall times of the most recent timed run, keyed by phase name
# (seconds, accumulated across enters).
phase_records: dict[str, float] = {}


def set_timing(mode: int) -> None:
    """Enable phase timing: 0 = off, 1 = wall clock, 2 = wall clock with a
    device synchronisation at the end of each phase that fenced work."""
    global _TIMING, _FENCE
    _TIMING = mode in (1, 2)
    _FENCE = mode == 2


# Host work counted on every call, by name (``reset_counters`` zeroes it):
# plan.copied_bytes   bytes of the slices the decode planner's frame walk
#                     takes of the buffer it is handed (``plan._plan_frame``)
# plan.planned_bytes  compressed bytes of the frames it planned
# plan.fse_descs      FSE_Compressed table descriptions it read
# plan.fse_descs_native those of them the native reader read
#                     (``native/seq_header.cpp``; the rest, the verbatim
#                     ``codec/fse.read_ncount``)
# dec.read_bytes      bytes the streaming Decoder's reads returned
# dec.frame_visits    frames those reads touched, one a frame a read
# dec.frame_hits      visits served by the frame the Decoder held
# dec.frame_load_bytes decompressed bytes of the frames it loaded (a large
#                     frame's streamed blocks included)
counters: dict[str, int] = {"plan.copied_bytes": 0, "plan.planned_bytes": 0,
                            "plan.fse_descs": 0, "plan.fse_descs_native": 0,
                            "dec.read_bytes": 0, "dec.frame_visits": 0,
                            "dec.frame_hits": 0, "dec.frame_load_bytes": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _enter_range(name: str):
    """The profiler range ``zk.<name>``, entered. It records as a host
    operation of the trace (category ``cpu_op``), as torch's own operators
    do, so a reader of the trace names the time it covers by it."""
    rf = _RecordFunctionFast("zk." + name)
    rf.__enter__()
    return rf


class trace_range:
    """``with trace_range("enc.host_decisions.huf"):`` is the profiler range
    ``zk.<name>`` while a ``torch.profiler`` records; free otherwise. It
    is not a phase: nothing reaches ``phase_records`` or stderr."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _enter_range(self.name) if _profiler._is_profiler_enabled else None
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class phase_timer:
    """``with phase_timer("enc.parse_dispatch") as pt:`` records the phase
    wall time in ``phase_records`` when timing is on, and is the profiler
    range ``zk.<name>`` while a ``torch.profiler`` records (as
    ``trace_range``); free otherwise.

    With timing mode 2, ``pt.fence(*tensors)`` makes the phase end with
    ``torch.cuda.synchronize()`` when any of the tensors lies on the card,
    so asynchronous kernel time is charged to the phase that launched it
    (profiling only: it serialises the pipeline)."""

    __slots__ = ("name", "t0", "_sync", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._sync = False

    def fence(self, *tensors):
        if _FENCE:
            self._sync = any(
                isinstance(t, torch.Tensor) and t.is_cuda for t in tensors
            )
        return self

    def __enter__(self):
        self._rf = _enter_range(self.name) if _profiler._is_profiler_enabled else None
        if _TIMING:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _TIMING:
            if self._sync and not any(exc):
                torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            phase_records[self.name] = phase_records.get(self.name, 0.0) + dt
            print(f"[timing] {self.name}: {dt:.6f}s", file=sys.stderr, flush=True)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False
