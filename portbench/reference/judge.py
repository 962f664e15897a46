"""What decides ``correct``: every number compared here is exact, with the
limit 0.

- ``count_bad_bytes``: the program's decoded bytes against the input made
  from the seed (every decode and every query of the run).
- ``judge_archive``: an archive the program wrote, read by the plain decoder
  alone: the seek table against the configuration's frame cut, and every
  frame decoded and compared with its slice of the input, its checksum flag
  as the configuration states and its checksum verified.
"""

from __future__ import annotations

import struct

import numpy as np

from .zstd_plain import Corrupt, decode_frame, parse_seek_table_foot


def count_bad_bytes(got: bytes, want) -> int:
    """Bytes of ``got`` that differ from ``want``, plus the length gap."""
    if len(got) == len(want) and got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def expected_cut(size: int, frame_size: int) -> list[int]:
    """The decompressed size of each frame under a cut every ``frame_size``."""
    if size == 0:
        return [0]
    return [min(frame_size, size - s) for s in range(0, size, frame_size)]


def judge_archive(archive: bytes, data: bytes, frame_size: int, checksum: bool) -> dict:
    """``table_faults``: seek-table entries that differ from the cut, plus
    one for a table that does not parse or does not span the frames.
    ``ref_bad_frames``: frames the plain decoder rejects, decodes to other
    bytes than the input's, or finds with a checksum flag unlike the
    configuration's. ``frames``: the frames the cut asks for."""
    cut = expected_cut(len(data), frame_size)
    res = {"table_faults": 0, "ref_bad_frames": 0, "frames": len(cut)}
    try:
        entries, table_start = parse_seek_table_foot(archive)
    except Corrupt:
        res["table_faults"] = 1
        res["ref_bad_frames"] = len(cut)
        return res
    res["table_faults"] += abs(len(entries) - len(cut))
    res["table_faults"] += sum(d != want for (_c, d), want in zip(entries, cut))
    if sum(c for c, _d in entries) != table_start:
        res["table_faults"] += 1
    frames = archive[:table_start]
    cpos = dpos = 0
    bad = 0
    for c, d in entries:
        try:
            content, end, has_checksum = decode_frame(frames, cpos)
            if (end != cpos + c or has_checksum != checksum or len(content) != d
                    or content != data[dpos:dpos + d]):
                bad += 1
        except (Corrupt, IndexError, struct.error):
            bad += 1
        cpos += c
        dpos += d
    # A frame the cut asks for and the table leaves out is a bad frame too.
    res["ref_bad_frames"] = bad + max(0, len(cut) - len(entries))
    return res

