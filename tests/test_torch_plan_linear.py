"""The decode planner walks an archive at offsets (``plan._plan_frame``),
on the CPU:

- every frame planned inside a whole archive, through its seek table and
  by the walk without one, gives the JAX package's plan and end position;
- the planner slices each byte it plans about once
  (``plan.copied_bytes / plan.planned_bytes``) and twice the frames cost
  twice the bytes sliced: a planner that sliced the rest of the buffer at
  each header would grow with the square of the archive;
- truncated and corrupt archives raise the JAX package's exceptions.

Small level-1 archives of word text in 8 and 64 KiB frames, a few seconds
in all."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from zeekstd_tpu import tpu_archive as ref_archive
from zeekstd_tpu.tpu_codec import _plan_frame as ref_plan_frame
from zeekstd_tpu_torch import archive, device, plan
from zeekstd_tpu_torch.codec import frame as frame_mod

from .block_cases import word_text
from .torch_threads import two_torch_threads  # noqa: F401

DATA = word_text(256 << 10)
SMALL = 8 << 10  # one block a frame
TWO_BLOCKS = 64 << 10  # two 32 KiB blocks a frame


def _archive(n, frame_size):
    """(the archive with its seek table at the end, SeekTable)."""
    blob, st = archive.compress_archive(DATA[:n], frame_size=frame_size, level=1,
                                        checksum=True, device="cpu")
    return blob + st.to_bytes(), st


@pytest.fixture(scope="module")
def archives():
    return {16: _archive(128 << 10, SMALL), 32: _archive(256 << 10, SMALL),
            4: _archive(256 << 10, TWO_BLOCKS)}


def _norm(x):
    """A plan as plain values: bytes with their type, tables by their
    fields, arrays as lists."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return (type(x).__name__, bytes(x))
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: _norm(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    return x


def _same_plan(got, ref):
    (hdr, p, end), (rhdr, rp, rend) = got, ref
    assert end == rend
    assert dataclasses.asdict(hdr) == dataclasses.asdict(rhdr)
    assert _norm(p) == _norm(rp)


def _starts(st):
    return [st.frame_start_comp(i) for i in range(st.num_frames)]


@pytest.mark.parametrize("frames", [16, 32, 4])
def test_frames_inside_the_archive_match_reference(archives, frames):
    """Each frame planned at its offset of the whole archive, alone, through
    the seek table and by the walk without it, gives the reference's plan
    of that frame at that offset."""
    buf, st = archives[frames]
    assert st.num_frames == frames
    refs = [ref_plan_frame(buf, s) for s in _starts(st)]
    for s, ref in zip(_starts(st), refs):
        _same_plan(plan._plan_frame(buf, s), ref)
    for planned in (plan.plan_archive(buf, st), plan.plan_archive(buf, None)):
        assert len(planned) == frames
        for got, ref in zip(planned, refs):
            _same_plan(got, ref)


@pytest.mark.parametrize("frames", [16, 32, 4])
def test_each_planned_byte_is_sliced_about_once(archives, frames):
    buf, st = archives[frames]
    device.reset_counters()
    plan.plan_archive(buf, st)
    c = dict(device.counters)
    assert c["plan.planned_bytes"] == st.size_comp
    assert c["plan.copied_bytes"] / c["plan.planned_bytes"] <= 1.02


@pytest.mark.parametrize("with_table", [True, False])
def test_twice_the_frames_slice_twice_the_bytes(archives, with_table):
    """The 32-frame archive holds the 16-frame one's frames and 16 more of
    the same text: its plan slices twice the bytes, within 2%."""
    copied = []
    for frames in (16, 32):
        buf, st = archives[frames]
        device.reset_counters()
        plan.plan_archive(buf, st if with_table else None)
        copied.append(device.counters["plan.copied_bytes"])
    assert abs(copied[1] / copied[0] - 2) <= 0.04


def _last_frame(buf, st):
    start = st.frame_start_comp(st.num_frames - 1)
    return start, frame_mod.parse_frame_header(buf[start:]).header_size


def _cut_frame_header(buf, st):
    start, h = _last_frame(buf, st)
    return buf[: start + h - 1], None, start


def _cut_magic(buf, st):
    start, _h = _last_frame(buf, st)
    return buf[: start + 3], None, start


def _cut_block_header(keep):
    def case(buf, st):
        start, h = _last_frame(buf, st)
        return buf[: start + h + keep], None, start
    return case


def _cut_block(buf, st):
    start, h = _last_frame(buf, st)
    return buf[: start + h + 3 + 40], None, start


def _cut_dict_id(buf, st):
    """A frame header after the archive's frames whose 2-byte dictionary id
    holds one byte before the end of the buffer."""
    frames = buf[: st.size_comp]
    return frames + b"\x28\xb5\x2f\xfd\x02\x58\x07", None, len(frames)


def _extent_off(buf, st):
    """Frame 3's checksum flag cleared: it ends 4 bytes before its extent
    in the seek table."""
    start = st.frame_start_comp(3)
    bad = bytearray(buf)
    bad[start + 4] ^= 0x04
    return bytes(bad), st, start


def _error(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", [
    _cut_magic, _cut_frame_header, _cut_block_header(1), _cut_block_header(2),
    _cut_block, _cut_dict_id, _extent_off,
], ids=["magic_cut", "frame_header_cut", "block_header_cut_1", "block_header_cut_2",
        "block_cut", "dict_id_cut", "extent_off_seek_table"])
def test_truncated_and_corrupt_archives_raise_as_reference(archives, case):
    """The port's planner raises the reference's exception, by name and
    message, where the reference's archive decode raises in its own
    planning; on a frame the reference's ``_plan_frame`` rejects, the port's
    rejects it alike, and on one it accepts, both end in the same place."""
    bad, st, start = case(*archives[4])
    err = _error(plan.plan_archive, bad, st)
    assert err == _error(ref_archive.tpu_decompress_archive, bad, st)
    assert err == _error(archive.decompress_archive, bad, st, True, False, "cpu")
    if case is _extent_off:
        assert "frame 3 consumed" in err[1]
        assert plan._plan_frame(bad, start)[2] == ref_plan_frame(bad, start)[2]
    else:
        assert _error(plan._plan_frame, bad, start) == _error(ref_plan_frame, bad, start)
