"""PyTorch port: decoding in launch groups under a memory budget.

``plan.launch_groups`` splits an archive's frames into contiguous groups,
each launch's outputs and scratch within ``plan.LAUNCH_BYTES``. Its unit
tests come first. Then an archive of uneven frames (``frame_spans``, 96
KiB in all) is decoded on the CPU on the ring, wide (``ZEEKSTD_TPU_RING=0``),
serial (``ZEEKSTD_TPU_EXEC=serial``) and doubling (``=doubling``) routes
with the budget monkeypatched small, so that two or more groups form: the
bytes must equal the JAX package's decode of the same archive, the route's
kernel wrapper (the doubling route's torch executor) must be called once
per group, ``decode_frames`` and ``return_device`` must
give the bytes they give with one group, and a corrupted frame in the
second group must raise the error the JAX package raises on its route of
the same name.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from zeekstd_tpu import tpu_archive as ref_archive
from zeekstd_tpu.errors import ZeekstdError as RefZeekstdError
from zeekstd_tpu.seek_table import SeekTable as RefSeekTable
from zeekstd_tpu_torch import archive, plan
from zeekstd_tpu_torch.errors import ZeekstdError

from . import launch_cases
from .launch_cases import ROUTES, watch_groups
from .torch_threads import two_torch_threads  # noqa: F401


def _cost(n, bound, lits, extra):
    return n * (bound + lits) + extra


@pytest.mark.parametrize("seed", range(4))
def test_groups_are_contiguous_and_within_budget(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    bounds = rng.integers(1, 1000, n).tolist()
    lits = rng.integers(0, 500, n).tolist()
    extra = rng.integers(0, 50, n).tolist()
    budget = 3000
    monkeypatch.setattr(plan, "LAUNCH_BYTES", budget)

    def cost(lo, hi):
        return _cost(hi - lo, max(bounds[lo:hi]), max(lits[lo:hi]), sum(extra[lo:hi]))

    groups = plan.launch_groups(list(zip(bounds, lits)), extra, _cost)
    assert [lo for lo, _hi in groups] == [0] + [hi for _lo, hi in groups[:-1]]
    assert groups[-1][1] == n
    for lo, hi in groups:
        assert hi > lo
        assert hi - lo == 1 or cost(lo, hi) <= budget
        # Greedy: the next frame would have broken the budget.
        assert hi == n or cost(lo, hi + 1) > budget


def test_frame_over_budget_gets_a_group_of_its_own(monkeypatch):
    monkeypatch.setattr(plan, "LAUNCH_BYTES", 100)
    groups = plan.launch_groups([(b, 0) for b in (10, 10, 500, 10, 10)], [0] * 5, _cost)
    assert groups == [(0, 2), (2, 3), (3, 5)]


def test_one_group_when_everything_fits(monkeypatch):
    monkeypatch.setattr(plan, "LAUNCH_BYTES", 1000)
    assert plan.launch_groups([(10, 5)] * 7, [1] * 7, _cost) == [(0, 7)]
    monkeypatch.setattr(plan, "LAUNCH_BYTES", 10)
    assert plan.launch_groups([(10, 0)] * 3, [0] * 3, _cost) == [(0, 1), (1, 2), (2, 3)]


@pytest.fixture(scope="module")
def uneven():
    """(blob, seek table, data, spans): 6 frames of 8-40 KiB, level 1."""
    return launch_cases.uneven("cpu")


@pytest.fixture
def grouped(request, monkeypatch):
    """Route ``request.param`` with its small budget; records the launch
    groups formed and the calls of the route's kernel wrapper."""
    env, (mod, attr), _key, budget = ROUTES[request.param]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(plan, "LAUNCH_BYTES", budget)
    seen = {"calls": 0, "watched": watch_groups(monkeypatch)}
    orig_fn = getattr(mod, attr)

    def call(*a, **k):
        seen["calls"] += 1
        return orig_fn(*a, **k)

    monkeypatch.setattr(mod, attr, call)
    return request.param, seen


def _groups(seen):
    """The groups of each ``plan.launch_groups`` call so far."""
    return [g for _args, g in seen["watched"]]


def _ref_table(st):
    return RefSeekTable.from_bytes(st.to_bytes())


@pytest.mark.parametrize("grouped", list(ROUTES), indirect=True)
def test_groups_decode_like_reference(uneven, grouped):
    blob, st, data, _spans = uneven
    _route, seen = grouped
    out = archive.decompress_archive(blob, st, device="cpu")
    (groups,) = _groups(seen)
    assert len(groups) >= 2 and any(hi - lo >= 2 for lo, hi in groups), groups
    assert seen["calls"] == len(groups)
    assert out == data
    assert out == ref_archive.tpu_decompress_archive(blob, _ref_table(st))


@pytest.mark.parametrize("grouped", list(ROUTES), indirect=True)
def test_groups_give_the_bytes_of_one_group(uneven, grouped, monkeypatch):
    blob, st, data, spans = uneven
    route, seen = grouped
    picks = [(st.frame_start_comp(i), st.frame_end_comp(i)) for i in (1, 2, 4)]

    def decode():
        rows, sizes = archive.decompress_archive(blob, st, return_device=True, device="cpu")
        parts = archive.decode_frames(blob, picks, device="cpu")
        return [rows[i, :n].numpy().tobytes() for i, n in enumerate(sizes)], rows.shape, parts

    grouped_out = decode()
    # decode_frames takes the fused route (ring) on every route setting.
    assert len(_groups(seen)[0]) >= 2, _groups(seen)
    n_calls = len(_groups(seen))
    monkeypatch.setattr(plan, "LAUNCH_BYTES", 1 << 40)
    one = decode()
    assert all(len(g) == 1 for g in _groups(seen)[n_calls:])
    assert grouped_out == one
    assert b"".join(grouped_out[0]) == data
    assert grouped_out[2] == [data[s : s + n] for s, n in (spans[1], spans[2], spans[4])]


def _outcome(decode, blob, original):
    try:
        out = decode(blob)
    except (ZeekstdError, RefZeekstdError) as e:
        return ("error", getattr(e, "name", type(e).__name__))
    return ("intact",) if out == original else ("silent",)


@pytest.mark.parametrize("grouped", list(ROUTES), indirect=True)
def test_corrupt_frame_in_second_group_fails_like_reference(uneven, grouped, monkeypatch):
    blob, st, data, _spans = uneven
    route, seen = grouped
    archive.decompress_archive(blob, st, device="cpu")
    (groups,) = _groups(seen)
    fi = groups[1][0]
    rng = np.random.default_rng(7)
    start, end = st.frame_start_comp(fi), st.frame_end_comp(fi)
    bad = bytearray(blob)
    for _ in range(3):
        bad[int(rng.integers(start + 8, end - 4))] ^= 1 << int(rng.integers(0, 8))
    got = _outcome(lambda b: archive.decompress_archive(b, st, device="cpu"), bytes(bad), data)
    # The JAX package on the route of the same name (its fused kernels and
    # serial executor in interpret mode).
    monkeypatch.setenv("ZEEKSTD_TPU_EXEC", route if route in ("serial", "doubling") else "fused")
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "1" if route == "ring" else "0")
    want = _outcome(lambda b: ref_archive.tpu_decompress_archive(b, _ref_table(st)),
                    bytes(bad), data)
    assert got[0] == "error" and got == want
