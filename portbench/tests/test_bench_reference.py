"""The plain reference: its decoder against libzstd where the python
binding is installed and against archives the program writes on the CPU,
and the judge against archives broken on purpose."""

import random

import pytest

from portbench.data.dickens_like import generate
from portbench.reference.judge import count_bad_bytes, expected_cut, judge_archive
from portbench.reference.zstd_plain import Corrupt, decode_frame, parse_seek_table_foot, xxh64

TEXT = generate(300_000, 11)


def test_xxh64_known_values():
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert xxh64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_decoder_reads_libzstd_frames(level):
    zstd = pytest.importorskip("zstandard")
    rng = random.Random(level)
    inputs = [TEXT, TEXT[:1], b"", b"ab" * 40_000, bytes(rng.randrange(256) for _ in range(5000)),
              TEXT[:70_000] + bytes(70_000) + TEXT[:70_000]]
    for data in inputs:
        for checksum in (False, True):
            frame = zstd.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
            out, end, has = decode_frame(frame + b"tail", 0)
            assert (out, end, has) == (data, len(frame), checksum)


def _port_archive(data, level, checksum, frame_size=65536):
    import zeekstd_tpu_torch as zt

    blob, st = zt.archive.compress_archive(data, frame_size=frame_size, checksum=checksum,
                                           level=level, device="cpu")
    return blob + st.to_bytes(zt.Format.FOOT)


@pytest.mark.parametrize("level,checksum", [(1, False), (3, True)])
def test_judge_passes_the_programs_archives(level, checksum):
    arc = _port_archive(TEXT[:150_000], level, checksum)
    res = judge_archive(arc, TEXT[:150_000], 65536, checksum)
    assert res == {"table_faults": 0, "ref_bad_frames": 0, "frames": 3}


def test_judge_finds_broken_archives():
    data = TEXT[:150_000]
    arc = _port_archive(data, 3, True)
    entries, start = parse_seek_table_foot(arc)
    # A byte altered inside the second frame.
    bad = bytearray(arc)
    bad[entries[0][0] + entries[1][0] // 2] ^= 1
    assert judge_archive(bytes(bad), data, 65536, True)["ref_bad_frames"] >= 1
    # The configuration says checksums, the archive has none.
    assert judge_archive(_port_archive(data, 3, False), data, 65536, True)["ref_bad_frames"] == 3
    # Another frame cut.
    arc2 = _port_archive(data, 3, True, frame_size=131072)
    assert judge_archive(arc2, data, 65536, True)["table_faults"] > 0
    # A truncated archive has no table.
    res = judge_archive(arc[:-3], data, 65536, True)
    assert res["table_faults"] == 1 and res["ref_bad_frames"] == 3
    # Another input.
    other = data[:-1] + b"!"
    assert judge_archive(arc, other, 65536, True)["ref_bad_frames"] == 1
    with pytest.raises(Corrupt):
        decode_frame(b"\x00" * 16)


def test_count_bad_bytes_and_cut():
    assert count_bad_bytes(b"abcd", b"abcd") == 0
    assert count_bad_bytes(b"abXd", b"abcd") == 1
    assert count_bad_bytes(b"ab", memoryview(b"abcd")) == 2
    assert expected_cut(5, 2) == [2, 2, 1]
    assert expected_cut(0, 2) == [0]
