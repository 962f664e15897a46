"""On the card, at each cell's own size: a sound run is correct, and each
configuration's control (the program with one guarantee broken) is not, on
three seeds. Run with ``python -m pytest -m gpu portbench/tests``."""

import pytest

from .helpers import CELLS, execute, planted

CONTROL = {"libbench-l1-2m": "control_frames", "loghub-hdfs-l3-2m": "control_checksum"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_on_the_card(card, name):
    line = execute(name, seed=4_000_000_001, seconds=2.0, tiny=False, device=None)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [4_000_000_011, 4_000_000_012, 4_000_000_013])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, monkeypatch, name, seed):
    with planted(monkeypatch, CONTROL[name.split(".")[0]]):
        line = execute(name, seed=seed, seconds=2.0, tiny=False, device=None)
    print(name, seed, {k: c["value"] for k, c in line["checks"].items()})
    assert not line["correct"], line["checks"]
