"""PyTorch port: the level-1 match finder's edge inputs against the JAX kernel.

The inputs of ``tests/match_edges.py`` at 64-78 KiB each go through the
port's plain version (``match_plain``, the yardstick the card test and
``chip_smoke.py`` hold the CUDA kernel against) and through the JAX
kernel in Pallas interpret mode. Stat rows, sequence rows up to their
count and literal rows up to theirs must be equal. The ``window`` case
needs a frame of more than 512 KiB and runs on the card only
(``test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from zeekstd_tpu.ops import fse_kernel as ref_fk
from zeekstd_tpu.ops import match_kernel as ref_mk
from zeekstd_tpu_torch.ops import match_kernel as mk

from . import match_edges
from .torch_threads import two_torch_threads  # noqa: F401

CASES = [n for n in match_edges.NAMES if n != "window"]
N = 64 << 10


def _run(name):
    rows, lengths, BLK, SBd = match_edges.edge_case(name, N)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    consts = ref_fk.make_consts()
    kern = ref_mk.get_match_kernel(BLK, SBd, meta.shape[0], interpret=True)
    ref = [np.asarray(a) for a in kern(consts, meta, words)]
    port = [t.numpy() for t in mk.match(
        torch.from_numpy(consts), torch.from_numpy(meta), torch.from_numpy(words),
        BLK=BLK, SBd=SBd, n_frames=rows.shape[0])]
    return lengths, BLK, SBd, port, ref


@pytest.mark.parametrize("name", CASES)
def test_edge_input_equals_jax_kernel(name):
    lengths, BLK, SBd, (lm, ofv, litw, stat), (rlm, rofv, rlitw, rstat) = _run(name)
    np.testing.assert_array_equal(stat, rstat)
    lb, rlb = litw.view(np.uint8), rlitw.view(np.uint8)
    for r in range(stat.shape[0]):
        n, nl = stat[r, mk.ST_NSEQ], stat[r, mk.ST_LITCNT]
        np.testing.assert_array_equal(lm[r, :n], rlm[r, :n])
        np.testing.assert_array_equal(ofv[r, :n], rofv[r, :n])
        np.testing.assert_array_equal(lb[r, :nl], rlb[r, :nl])
    # Each input reaches the branch it was made for.
    ml = lm & 0xFFFF
    nseq = stat[:, mk.ST_NSEQ]
    if name in ("zeros", "period1", "period3"):
        assert ml.max() > 1024  # many 128-byte extension rounds
    if name == "zeros":
        assert ml.max() == BLK  # a whole block, capped at its end
    if name == "random":
        assert nseq.sum() == 0 and stat[:, mk.ST_LITCNT].sum() == lengths.sum()
    if name == "short_tail":
        assert sorted(int(x) % BLK for x in lengths) == [7, 12345]
    if name == "overflow":
        assert SBd == 64 and stat[:, mk.ST_OVERFLOW].sum() > 0
    if name == "frames":
        assert len(lengths) == 3 and (nseq[:3] > 0).all()
