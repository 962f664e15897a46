"""The seeded input."""

import pytest

from portbench import manifest

from .helpers import BENCH


@pytest.mark.parametrize("name", ["dickens_like", "hdfs_v1_like"])
def test_generator_is_deterministic_per_seed_and_differs_between_seeds(name):
    gen = manifest.generator(name)
    a = gen(200_000, 2**31 + 77)
    assert a == gen(200_000, 2**31 + 77)
    assert a != gen(200_000, 2**31 + 78)
    assert len(a) == 200_000


def test_generator_makes_the_configured_size():
    for entry in BENCH["configs"]:
        cfg = manifest.config(BENCH, entry["name"])
        data = manifest.generator(cfg["data"]["generator"])(cfg["data"]["bytes"], 3)
        assert len(data) == cfg["data"]["bytes"]
        assert cfg["data"]["bytes"] == {"dickens_like": 10_192_446,
                                        "hdfs_v1_like": 64 * 2**20}[cfg["data"]["generator"]]


def test_the_log_has_the_format_of_hdfs_v1():
    lines = manifest.generator("hdfs_v1_like")(400_000, 2**31 + 5).decode().split("\n")[:-1]
    blocks = set()
    for line in lines:
        date, time, thread, level, component, _ = line.split(" ", 5)
        assert len(date) == 6 and len(time) == 6 and thread.isdigit()
        assert level in ("INFO", "WARN") and component.startswith("dfs.")
        blocks.update(w.rstrip(":") for w in line.split() if w.startswith("blk_"))
    # Each block appears on many lines, as in HDFS_v1 (19.4 lines a block).
    assert 10 < len(lines) / len(blocks) < 25
