"""``correct`` comes out false with the program broken underneath the
harness (the chip's look skipped: the kernels' plain versions on the CPU),
for each fault a cell can have, and for each configuration's control: the
program with one guarantee of the configuration broken."""

import pytest

from .helpers import execute, planted

FAULTS = {
    "libbench-l1-2m.archive": ["control_frames", "flip_encode", "half_encode", "flip_decode",
                               "half_decode", "zeros_decode"],
    "loghub-hdfs-l3-2m.archive": ["control_checksum", "flip_encode", "half_encode",
                                  "flip_decode", "half_decode", "zeros_decode"],
    "loghub-hdfs-l3-2m.stream": ["control_checksum", "flip_encode", "half_encode", "flip_frame",
                                 "stale_frame"],
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    with planted(monkeypatch, fault):
        line = execute(cell, seed=3, seconds=0.2)
    assert not line["correct"], line["checks"]
    broken = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert broken
