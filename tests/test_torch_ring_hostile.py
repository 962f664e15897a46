"""PyTorch port: the ring contract on hostile records, against the JAX kernel.

The ring route's records, bitstream words, table pools and literal pools
for a 48 KiB level-1 archive in six 8 KiB frames are captured from the
port's CPU decode, mutated as ``test_torch_wide_hostile.py`` mutates the
wide route's (one mutation per frame, seeded), and fed as the same numpy
arrays to the port's ``ring_decode`` (on the CPU: ``ring_plain``) and to
the JAX ring kernel in interpret mode. The hand-built cases of
``ring_cases`` add the places where the ring contract differs from the
wide one: offsets over 512 KiB in a frame longer than 512 KiB, literal
runs past their block's budget, sequences that read below their four-word
window, and a match at position 0. meta_out columns 0-2 and the output
bytes up to each frame's total must be equal.

A match at a frame's position 0 copies the byte before the frame. The
port reads it as 0, as the wide route's JAX kernel does; the JAX ring
kernel reads the slot of its output ring that no frame wrote, which on
the chip holds whatever that memory held and in interpret mode the fill
value of unwritten scratch (int32 min). The reference kernel here is
traced with that fill set to 0, so the two are held equal on those bytes
too; every byte a frame wrote itself is unaffected.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax._src.pallas import primitives as pallas_primitives

from zeekstd_tpu.ops import ring_kernel as ref_rk
from zeekstd_tpu_torch import archive, decode_routes
from zeekstd_tpu_torch.ops import ring_kernel as rk

from . import ring_cases
from .test_torch_wide_hostile import FRAME, _data, _mutate
from .torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def ring_call():
    blob, _st = archive.compress_archive(_data(), frame_size=FRAME, level=1, checksum=True,
                                         device="cpu")
    calls = []
    orig = rk.ring_decode

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    rk.ring_decode = rec
    try:
        archive.decompress_archive(blob, device="cpu")
    finally:
        rk.ring_decode = orig
    (a, k), = calls
    return [t.numpy() for t in a], k["OUTB"]


_kernels = {}


def _ref_ring(monkeypatch, words, OUTB, meta, litw):
    """The JAX ring kernel in interpret mode for these shapes, traced with
    unwritten scratch read as 0."""
    fill = pallas_primitives.uninitialized_value

    def zero_fill(shape, dtype):
        if jnp.issubdtype(dtype, jnp.integer):
            return jnp.zeros(shape, dtype)
        return fill(shape, dtype)

    monkeypatch.setattr(pallas_primitives, "uninitialized_value", zero_fill)
    key = (words.shape[1], OUTB, meta.shape[0], litw.shape[0], litw.shape[1])
    if key not in _kernels:
        _kernels[key] = ref_rk._build(key[0], decode_routes.LITB, *key[1:], interpret=True)
    return _kernels[key]


@pytest.mark.parametrize("case", ("counts", "bits", "rows") + ring_cases.NAMES)
def test_ring_contract_equals_ring_kernel_on_hostile_records(ring_call, monkeypatch, case):
    if case in ring_cases.NAMES:
        (consts, meta, words, tables, litw), OUTB = ring_cases.ring_case(case)
    else:
        (consts, meta, words, tables, litw), OUTB = ring_call
        meta, words = _mutate(case, meta, words, tables)
    kern = _ref_ring(monkeypatch, words, OUTB, meta, litw)
    ref_out, ref_meta = (np.asarray(x) for x in kern(consts, meta, words, tables, litw))
    out, meta_out = rk.ring_decode(*(torch.from_numpy(x) for x in
                                     (consts, meta, words, tables, litw)), OUTB=OUTB)
    np.testing.assert_array_equal(meta_out.numpy()[:, :3], ref_meta[:, :3])
    assert ref_meta[:, 1].any(), "every case marks a frame bad"
    F = out.shape[0]
    ob, rb = out.numpy().view(np.uint8).reshape(F, -1), ref_out.view(np.uint8).reshape(F, -1)
    for f, tot in enumerate(ref_meta[:, 0]):
        np.testing.assert_array_equal(ob[f, :tot], rb[f, :tot])
