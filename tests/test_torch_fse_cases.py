"""PyTorch port: the FSE encoder's plain version against the JAX kernel on
the cases of ``tests/fse_enc_cases.py``.

The same numpy arrays go through ``fse_kernel.fse_plain`` and the JAX
kernel in interpret mode (at ``word_bound(SBd)`` words per job, so the
``overflow`` case's reference keeps the words past its small WBo). Bit
counts must be equal, and words up to and including word ``bits // 32``
(below WBo). The card tests hold the CUDA kernel to ``fse_plain`` on the
same cases.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.ops import fse_kernel as ref_fk
from zeekstd_tpu_torch.ops import fse_kernel as fk

from . import fse_enc_cases
from .torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", fse_enc_cases.CASES)
def test_plain_equals_jax_kernel(name):
    consts, meta, lm, ofv, tables, SBd, WBo = fse_enc_cases.case(name)
    words, bits = fk.fse_plain(*(torch.from_numpy(x) for x in (consts, meta, lm, ofv, tables)),
                               SBd, WBo)
    kern = ref_fk.get_fse_kernel(SBd, fk.word_bound(SBd), meta.shape[0], interpret=True)
    ref_words, ref_bits = (np.asarray(x) for x in
                           kern(consts, meta, lm.reshape(-1), ofv.reshape(-1), tables))
    np.testing.assert_array_equal(bits.numpy(), ref_bits)
    got = words.numpy().view(np.uint32)
    for j, nb in enumerate(ref_bits.tolist()):
        n = min(nb // 32 + 1, WBo)
        if meta[j, fk.J_NSEQ] <= 0:  # the JAX kernel leaves such a job's words unwritten
            assert nb == 0 and got[j, 0] == 0
            continue
        np.testing.assert_array_equal(got[j, :n], ref_words[j, :n], err_msg=f"job {j}")


def test_cases_reach_their_edges():
    """Each case holds what its name promises."""
    K = fk.CHUNK
    _c, meta, lm, ofv, tables, SBd, _w = fse_enc_cases.case("nseq")
    assert {1, 2, K - 1, K, K + 1, 2 * K + 1, SBd, 0, -3} <= set(meta[:, fk.J_NSEQ].tolist())
    _c, meta, *_ = fse_enc_cases.case("rle")
    logs = meta[:4, fk.J_LOGS]
    for j, shift in enumerate((0, 5, 10)):
        assert (logs[j] >> shift) & 31 == 0
    assert logs[3] == 0
    _c, meta, lm, ofv, *_ = fse_enc_cases.case("code_edges")
    n = int(meta[0, fk.J_NSEQ])
    ll = lm[0, :n].view(np.uint32) >> 16
    assert {0, 63, 64, 65535} <= set(ll.tolist()) and int(ofv[0, :n].max()) == 1 << 30
    _c, meta, _lm, _ofv, tables, *_ = fse_enc_cases.case("tidx_out_of_range")
    rows = meta[:3, fk.J_TLL : fk.J_TML + 1]
    assert (rows >= tables.shape[0]).sum() >= 5
    consts, meta, lm, ofv, tables, SBd, WBo = fse_enc_cases.case("overflow")
    _words, bits = fk.fse_plain(*(torch.from_numpy(x) for x in (consts, meta, lm, ofv, tables)),
                                SBd, WBo)
    assert int(bits.max()) > 32 * WBo > int(bits[bits > 0].min())
