"""The port's phases as profiler ranges and its host counters, on the CPU
(``zeekstd_tpu_torch.device``): ``phase_timer`` and ``trace_range`` open
``zk.<name>`` while a ``torch.profiler`` records and nothing otherwise;
``counters`` holds the bytes the decode planner slices and plans and the
FSE table descriptions it reads. No JAX, no child process: one small
archive, a few seconds in all."""

import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zeekstd_tpu_torch as zt
from zeekstd_tpu_torch import archive, device
from zeekstd_tpu_torch.codec import frame as frame_mod

from .block_cases import word_text
from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 65536  # two 32 KiB blocks a frame
DATA = word_text(4 * FRAME)
HOST_LOOPS = ("enc.host_decisions.blocks", "enc.host_decisions.huf",
              "enc.host_decisions.fse_tables")
# Ranges that are not phases on an archive's path: the loops above, the
# input copied into frame rows, the decoded frames joined.
NOT_PHASES = HOST_LOOPS + ("enc.input_rows", "dec.join")
# The streaming Decoder's counters, which an archive's decode leaves alone.
DEC_ZERO = {"dec.read_bytes": 0, "dec.frame_visits": 0, "dec.frame_hits": 0,
            "dec.frame_load_bytes": 0}
# The planner's counts of FSE table descriptions, all and native, zeroed.
FSE_ZERO = {"plan.fse_descs": 0, "plan.fse_descs_native": 0}


@pytest.fixture
def timing_mode():
    """Sets the phase timing for one test and restores it after, with
    ``phase_records`` emptied on both sides."""
    saved = (device._TIMING, device._FENCE)
    device.phase_records.clear()
    yield device.set_timing
    device._TIMING, device._FENCE = saved
    device.phase_records.clear()


def _roundtrip():
    blob, st = archive.compress_archive(DATA, frame_size=FRAME, level=1, device="cpu")
    assert archive.decompress_archive(blob, st, device="cpu") == DATA
    return blob, st


def _zk_ranges(prof):
    """[(start, end, name)] of the ``zk.`` ranges, name without ``zk.``."""
    return sorted((e.time_range.start, e.time_range.end, e.name[3:])
                  for e in prof.events() if e.name.startswith("zk."))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_profiler_ranges_follow_the_phases(timing_mode, capsys):
    """Under the profiler with wall-clock timing, the ranges are the phases
    the ``[timing]`` lines report, one each, plus one of each range that is
    not a phase; the three loops of the host decisions lie inside the
    ``enc.host_decisions`` range."""
    timing_mode(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _roundtrip()
    phases = sorted(ln.split("] ", 1)[1].split(":", 1)[0]
                    for ln in capsys.readouterr().err.splitlines()
                    if ln.startswith("[timing] "))
    ranges = _zk_ranges(prof)
    names = [n for _a, _b, n in ranges]
    assert sorted(n for n in names if n not in NOT_PHASES) == phases
    assert sorted(n for n in names if n in NOT_PHASES) == sorted(NOT_PHASES)
    assert {"enc.host_decisions", "enc.parse_dispatch", "dec.plan", "dec.fused_exec"} <= set(names)
    assert not set(NOT_PHASES) & set(device.phase_records)
    host = [r for r in ranges if r[2] == "enc.host_decisions"]
    assert len(host) == 1
    for loop in HOST_LOOPS:
        (r,) = [r for r in ranges if r[2] == loop]
        assert _inside(r, host[0])
    # The loops run one after another.
    starts = [next(r for r in ranges if r[2] == loop) for loop in HOST_LOOPS]
    assert all(a[1] <= b[0] for a, b in zip(starts, starts[1:]))


def test_streaming_layer_ranges():
    """The Encoder's flush holds the archive phases; each frame the Decoder
    loads is one ``dec.frame_load`` range holding that frame's plan."""
    sink = io.BytesIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc = (zt.EncodeOptions().with_backend("tpu").with_device("cpu")
               .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(FRAME))
               .with_compression_level(1).into_encoder(sink))
        enc.write(DATA)
        enc.finish(zt.Format.FOOT)
        dec = (zt.DecodeOptions(zt.BytesWrapper(sink.getvalue())).with_backend("tpu")
               .with_device("cpu").into_decoder())
        assert dec.read() == DATA
    ranges = _zk_ranges(prof)
    (flush,) = [r for r in ranges if r[2] == "enc.flush"]
    assert _inside(next(r for r in ranges if r[2] == "enc.host_decisions"), flush)
    loads = [r for r in ranges if r[2] == "dec.frame_load"]
    plans = [r for r in ranges if r[2] == "dec.plan"]
    assert len(loads) == len(plans) == 4
    assert all(_inside(p, ld) for p, ld in zip(plans, loads))


def test_silent_without_profiler_or_timing(timing_mode, capfd):
    timing_mode(0)
    assert not torch.autograd.profiler._is_profiler_enabled
    _roundtrip()
    assert device.phase_records == {}
    assert capfd.readouterr().err == ""


def test_plan_counters_count_planned_and_sliced_bytes():
    """``planned_bytes`` is the frames' compressed bytes; ``copied_bytes``
    at least that: every block is sliced once, with its 3-byte header, and
    each frame's header slice is 18 bytes, at least its header and the
    content checksum, which is not sliced; a second call doubles both; a
    reset zeroes."""
    blob, st = _roundtrip()
    frames = sum(st.frame_size_comp(i) for i in range(st.num_frames))
    headers = [frame_mod.parse_frame_header(blob[st.frame_start_comp(i):])
               for i in range(st.num_frames)]
    assert st.num_frames == 4
    device.reset_counters()
    assert device.counters == {"plan.copied_bytes": 0, "plan.planned_bytes": 0, **FSE_ZERO,
                               **DEC_ZERO}
    archive.decompress_archive(blob, st, device="cpu")
    once = dict(device.counters)
    assert once["plan.planned_bytes"] == frames
    assert once["plan.copied_bytes"] >= frames
    assert once["plan.copied_bytes"] == frames + sum(
        18 - h.header_size - 4 * h.has_checksum for h in headers)
    archive.decompress_archive(blob, st, device="cpu")
    assert device.counters == {k: 2 * v for k, v in once.items()}
    device.reset_counters()
    assert set(device.counters.values()) == {0}


def test_plan_counters_one_block_frame():
    """A frame of one block, planned alone: the frame header's slice is
    its 18 bytes at most, the block header's its 3 bytes, the block's its
    size; its three sequence tables are FSE descriptions, all read by the
    native reader."""
    blob, st = archive.compress_archive(DATA[:4096], frame_size=FRAME, level=1,
                                        checksum=True, device="cpu")
    n, h = len(blob), frame_mod.parse_frame_header(blob).header_size
    block_size = n - h - 3 - 4
    device.reset_counters()
    out, end = archive.decompress_frame(blob, device="cpu")
    assert out == DATA[:4096] and end == n
    assert device.counters == {"plan.copied_bytes": min(18, n) + 3 + block_size,
                               "plan.planned_bytes": n, "plan.fse_descs": 3,
                               "plan.fse_descs_native": 3, **DEC_ZERO}
    device.reset_counters()
