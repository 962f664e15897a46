"""The streaming Decoder's random reads on the CPU (``zeekstd_tpu_torch.decode``):
``seek`` and ``read`` at seeded and edge offsets against the input's slices,
the ``dec.*`` counters of ``device.counters`` against counts made by hand,
and one profiler range ``zk.dec.read`` a read around its frame loads. No
JAX: one level-3 archive of five 64 KiB frames, the last one short."""

import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import zeekstd_tpu_torch as zt
from zeekstd_tpu_torch import decode, device

from .block_cases import word_text
from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 65536
LAST = 12345  # the last frame's bytes
DATA = word_text(4 * FRAME + LAST, seed=5)[:4 * FRAME + LAST]
BLOCK = 32768  # the archive's blocks, which a frame too large to hold streams one at a time
DEC = ("dec.read_bytes", "dec.frame_visits", "dec.frame_hits", "dec.frame_load_bytes")


@pytest.fixture(scope="module")
def arc():
    blob, st = zt.archive.compress_archive(DATA, frame_size=FRAME, checksum=True, level=3,
                                           device="cpu")
    assert st.num_frames == 5
    return blob + st.to_bytes(zt.Format.FOOT)


def _decoder(arc, backend="tpu"):
    opts = zt.DecodeOptions(zt.BytesWrapper(arc)).with_backend(backend)
    return opts.with_device("cpu").into_decoder() if backend == "tpu" else opts.into_decoder()


def _dec_counters():
    return tuple(device.counters[k] for k in DEC)


_r = np.random.default_rng(22)
SEEDED = [(os.SEEK_SET, int(o), int(n))
          for o, n in zip(_r.integers(0, len(DATA), 5), _r.integers(1, 3 * FRAME, 5))]
READS = {
    "seeded": SEEDED,
    "across_two_frames": [(os.SEEK_SET, 2 * FRAME - 700, 1500)],
    "to_the_archive_end": [(os.SEEK_SET, len(DATA) - 900, 900)],
    "past_the_archive_end": [(os.SEEK_SET, len(DATA) - 40, 4000), (os.SEEK_CUR, 0, 10)],
    "zero_length": [(os.SEEK_SET, FRAME + 17, 0)],
    "after_seek_end": [(os.SEEK_END, -3000, 2000), (os.SEEK_END, 0, 100)],
}


@pytest.mark.parametrize("case", list(READS))
def test_reads_equal_the_input_slices(arc, case):
    dec = _decoder(arc)
    for whence, offset, n in READS[case]:
        at = dec.seek(offset, whence)
        assert dec.read(n) == DATA[at:at + n]
        assert dec.tell() == min(at + n, len(DATA))


@pytest.mark.parametrize("backend", ["tpu", "python"])
def test_counters_equal_hand_counts(arc, backend):
    """Each read adds its bytes; each frame it touches is a visit, a hit
    where the Decoder holds that frame, else a load of the frame's bytes.
    A seek out of the held frame lets it go."""
    dec = _decoder(arc, backend)
    device.reset_counters()
    steps = [  # (offset, length) -> (read, visits, hits, load bytes)
        ((100, 200), (200, 1, 0, FRAME)),
        ((5000, 100), (100, 1, 1, 0)),                 # the frame held
        ((FRAME - 50, 100), (100, 2, 1, FRAME)),       # held, then the next frame loaded
        ((10, 10), (10, 1, 0, FRAME)),                 # the seek let frame 1 go
        ((20, 0), (0, 0, 0, 0)),
        ((len(DATA) - 5, 100), (5, 1, 0, LAST)),       # the short last frame
        ((len(DATA), 10), (0, 0, 0, 0)),               # at the end, no frame
    ]
    want = np.zeros(4, np.int64)
    for (offset, n), add in steps:
        dec.seek(offset)
        assert dec.read(n) == DATA[offset:offset + n]
        want += add
        assert _dec_counters() == tuple(want)
    device.reset_counters()


def test_counters_of_a_frame_too_large_to_hold(arc, monkeypatch):
    """A frame above ``FRAME_CACHE_MAX`` streams block by block: the blocks
    up to the read's end are its load; a read ahead in the same frame keeps
    the stream (a hit), one behind it starts the frame over."""
    monkeypatch.setattr(decode, "FRAME_CACHE_MAX", FRAME - 1)
    dec = _decoder(arc)
    device.reset_counters()
    for offset, n in ((100, 200), (40_000, 100), (1000, 10)):
        dec.seek(offset)
        assert dec.read(n) == DATA[offset:offset + n]
    assert _dec_counters() == (310, 3, 1, 3 * BLOCK)
    device.reset_counters()


def test_one_read_range_around_its_frame_loads(arc):
    dec = _decoder(arc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for offset, n in ((100, 10), (200, 10), (3 * FRAME - 5, 10)):
            dec.seek(offset)
            dec.read(n)
        buf = bytearray(20)
        dec.seek(FRAME)
        assert dec.readinto(buf) == 20 and bytes(buf) == DATA[FRAME:FRAME + 20]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in ("zk.dec.read", "zk.dec.frame_load"))
    reads = [(a, b) for a, b, n in spans if n == "zk.dec.read"]
    loads = [(a, b) for a, b, n in spans if n == "zk.dec.frame_load"]
    assert len(reads) == 4
    # Frame 0, held for the second read, frames 2 and 3, then frame 1.
    assert len(loads) == 4
    assert [sum(a <= c and d <= b for c, d in loads) for a, b in reads] == [1, 0, 2, 1]


def test_reset_counters_zeroes_the_decoder_counters(arc):
    dec = _decoder(arc)
    device.reset_counters()
    dec.seek(FRAME)
    dec.read(100)
    dec.read(100)  # the held frame: a hit
    assert _dec_counters() == (200, 2, 1, FRAME)
    device.reset_counters()
    assert all(device.counters[k] == 0 for k in DEC)
