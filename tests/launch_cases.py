"""Cases of the launch-group tests, shared by the CPU tests and the card's.

An archive of uneven frames (``frame_spans``, 96 KiB in all, level 1) and,
per decode route, its environment, the wrapper its launches go through,
that wrapper's key in ``ops.launches`` (None for the doubling route, whose
executor is torch), and a ``plan.LAUNCH_BYTES`` under which the archive
splits into groups of one and of several frames. Imports no JAX.
"""

import numpy as np

from zeekstd_tpu_torch import archive, plan
from zeekstd_tpu_torch.ops import decode_kernel as dk
from zeekstd_tpu_torch.ops import exec_kernel as ek
from zeekstd_tpu_torch.ops import ring_kernel as rk
from zeekstd_tpu_torch.ops import seq_exec
from zeekstd_tpu_torch.ops._launch import ALLOC_SLACK

SPANS_KIB = (8, 8, 40, 8, 24, 8)
ROUTES = {
    "ring": ({}, (rk, "ring_decode"), "ring_decode", ALLOC_SLACK + (1 << 20)),
    "wide": ({"ZEEKSTD_TPU_RING": "0"}, (dk, "wide_decode"), "wide_decode",
             ALLOC_SLACK + (4 << 20)),
    "serial": ({"ZEEKSTD_TPU_EXEC": "serial"}, (ek, "serial_exec"), "exec",
               ALLOC_SLACK + (40 << 20)),
    "doubling": ({"ZEEKSTD_TPU_EXEC": "doubling"}, (seq_exec, "execute_sequences_batch"), None,
                 ALLOC_SLACK + (8 << 20)),
}


def data():
    rng = np.random.default_rng(12)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(180)]
    text = b" ".join(words[rng.integers(0, 180)] for _ in range(20000))
    return (text[:50000] + bytes(rng.integers(0, 256, 8000, dtype=np.uint8)) + b"Z" * 3000
            + text[50000:])[: sum(SPANS_KIB) << 10]


def uneven(device):
    """(blob, seek table, data, spans): 6 frames of 8-40 KiB, level 1."""
    raw = data()
    spans, start = [], 0
    for kib in SPANS_KIB:
        spans.append((start, kib << 10))
        start += kib << 10
    blob, st = archive.compress_archive(raw, level=1, checksum=True, frame_spans=spans,
                                        device=device)
    return blob, st, raw, spans


def group_costs(args, groups):
    """Each group's ``launch_bytes`` count, from the arguments of the
    ``plan.launch_groups`` call that formed ``groups``."""
    maxed, summed, launch_bytes = args
    maxed, summed = (np.asarray(c, np.int64).reshape(len(c), -1) for c in (maxed, summed))
    return [launch_bytes(hi - lo, *maxed[lo:hi].max(0).tolist(), *summed[lo:hi].sum(0).tolist())
            for lo, hi in groups]


def watch_groups(monkeypatch):
    """Record every ``plan.launch_groups`` call: its arguments and groups."""
    seen = []
    orig = plan.launch_groups

    def groups(*a):
        seen.append((a, orig(*a)))
        return seen[-1][1]

    monkeypatch.setattr(plan, "launch_groups", groups)
    return seen
