"""PyTorch port: the device entropy decode of the serial and doubling
routes against the JAX package.

- ``entropy.fse_decode_sequences`` (the ``fse_decode`` kernel's plain
  version) equals the reference's packed FSE batch decode
  (``tpu_codec._get_fse_decode_packed_fn``) in all five outputs and
  ``hasrep``: on blocks planned from the port's own level-1 and level-3
  archives, from a libzstd level-6 frame (cross-block repeat offsets),
  from bit-flipped payloads, on random (hostile) tables and streams, and
  on the cases of ``tests/fse_cases.py`` (mutated start bits, sequence
  counts and table indices, rows past the kernel's staging budget, a
  chain of 12,000 sequences). The kernel's staging helpers
  (``stage_words``, ``staged_whole``) are held to what the walk reads.
- ``huffman_spec.decode_stream_bitreach`` (device Huffman decode: torch
  glue and the reachability kernels' plain versions) equals the
  reference's device Huffman batch on the CPU (``decode_stream_spec``),
  and once the reference's ``decode_stream_bitreach`` in interpret mode.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from zeekstd_tpu.ops import huffman_spec as ref_hs
from zeekstd_tpu.tpu_archive import _huf_batch_dev as ref_huf_batch_dev
from zeekstd_tpu.tpu_codec import _get_fse_decode_packed_fn
from zeekstd_tpu_torch import archive, decode_routes, device, plan
from zeekstd_tpu_torch.ops import decode_kernel as dk
from zeekstd_tpu_torch.ops import entropy, huffman_spec

from . import fse_cases
from .oracle import zstd_compress
from .torch_threads import two_torch_threads  # noqa: F401


def _text(n, seed=3):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(120)]
    return b" ".join(words[rng.integers(0, 120)] for _ in range(n // 5))[:n]


@pytest.fixture(scope="module")
def blobs():
    data = _text(48 << 10)
    out = {}
    for level in (1, 3):
        blob, _st = archive.compress_archive(data, frame_size=16 << 10, level=level,
                                             device="cpu")
        out[f"L{level}"] = blob
    # Over 128 KiB: libzstd cuts several blocks and carries repeat offsets
    # across them.
    out["libzstd6"] = zstd_compress(_text(160 << 10, seed=5), 6)
    return out


def _plans(blob):
    lay = plan.collect(plan.plan_archive(blob, None))
    return lay.streams, lay.seq_blocks, lay.frame_rows


def _flipped(seq_blocks, seed):
    rng = np.random.default_rng(seed)
    out = []
    for d in seq_blocks:
        p = bytearray(d["payload"])
        for _ in range(3):
            p[int(rng.integers(0, len(p)))] ^= 1 << int(rng.integers(0, 8))
        out.append({**d, "payload": bytes(p)})
    return out


def _compare(words, starts, nseqs, tidx, packed, logs_t, seq_bound):
    ref = _get_fse_decode_packed_fn(words.shape[1], seq_bound)(
        jnp.asarray(words), jnp.asarray(starts), jnp.asarray(nseqs), jnp.asarray(tidx),
        jnp.asarray(packed), jnp.asarray(logs_t))
    st = device.from_reference_arrays("cpu", words=words, starts=starts, nseqs=nseqs,
                                      tidx=tidx, tables=packed, logs=logs_t,
                                      consts=dk.make_consts())
    got = entropy.fse_decode_sequences(st["words"], st["starts"], st["nseqs"], st["tidx"],
                                       st["tables"], st["logs"], st["consts"],
                                       seq_bound=seq_bound)
    ref = list(ref)
    ref[4] = np.stack([np.asarray(r) for r in ref[4]], axis=1)  # (r1, r2, r3) per block
    names = ("lls", "mls", "offs", "ofvs", "reps", "hasrep")
    for name, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    return got


@pytest.mark.parametrize("source", ["L1", "L3", "libzstd6", "L3-flipped", "libzstd6-flipped"])
def test_fse_decode_equals_reference(blobs, source):
    _streams, seq_blocks, _rows = _plans(blobs[source.split("-")[0]])
    assert seq_blocks
    if source.endswith("flipped"):
        seq_blocks = _flipped(seq_blocks, seed=len(source))
    words, starts, tidx, packed, logs_t, _wb = plan.fse_stage(seq_blocks)
    nseqs = np.zeros(words.shape[0], np.int32)
    nseqs[: len(seq_blocks)] = [d["nseq"] for d in seq_blocks]
    seq_bound = 1 << max((int(nseqs.max()) - 1).bit_length(), 5)
    got = _compare(words, starts, nseqs, tidx, packed, logs_t, seq_bound)
    if source == "libzstd6":
        assert bool(got[5][1:len(seq_blocks)].any())  # cross-block repeat forms


def test_fse_decode_equals_reference_on_hostile_tables():
    """Random tables (symbols and bit counts up to 255, so offset codes
    over 31, wide reads and negative states) and random streams."""
    rng = np.random.default_rng(17)
    B, WB, T = 6, 16, 5
    words = rng.integers(0, 1 << 32, (B, WB), dtype=np.uint64).astype(np.uint32)
    starts = rng.integers(-40, WB * 32 + 40, B).astype(np.int32)
    nseqs = np.array([0, 1, 5, 32, 17, -3], np.int32)
    tidx = rng.integers(0, T, (B, 3)).astype(np.int32)
    sym = rng.integers(0, 256, (T, 512))
    nb = rng.integers(0, 256, (T, 512))
    base = rng.integers(0, 1 << 15, (T, 512))
    packed = (sym | (nb << 8) | (base << 16)).astype(np.int32)
    logs_t = rng.integers(0, 12, T).astype(np.int32)
    _compare(words, starts, nseqs, tidx, packed, logs_t, 32)


@pytest.mark.parametrize("name", fse_cases.CASES)
def test_fse_decode_cases_equal_reference(name):
    words, starts, nseqs, tidx, tables, logs_t, consts, seq_bound = fse_cases.case(name)
    assert seq_bound % 8 == 0 and np.array_equal(consts, dk.make_consts())
    _compare(words, starts, nseqs, tidx, tables, logs_t, seq_bound)


def test_stage_words(monkeypatch):
    assert entropy.stage_words(4096) == 4096 and entropy.stage_words(3) == 3
    assert entropy.stage_words(1 << 16) == entropy.STAGE_WORDS == 8192
    monkeypatch.setattr(entropy, "STAGE_WORDS", 66)
    assert entropy.stage_words(1 << 16) == 64
    monkeypatch.setattr(entropy, "STAGE_WORDS", 1)
    assert entropy.stage_words(1 << 16) == 4 and entropy.stage_words(2) == 2


@pytest.mark.parametrize("name", ["planned", "start_minus", "bit_flips", "wide_rows"])
def test_walk_reads_no_word_above_its_start(name):
    """On valid tables a row's walk reads no word above ``(start_bits >> 5)
    + 1`` (what ``staged_whole`` and the kernel's window rely on): noise
    there leaves every output unchanged. ``staged_whole`` holds the rows
    whose top fits the staging budget."""
    words, starts, nseqs, tidx, tables, logs_t, consts, seq_bound = fse_cases.case(name)
    B, WB = words.shape
    noisy = words.copy()
    rng = np.random.default_rng(5)
    tops = np.clip((starts.astype(np.int64) >> 5) + 2, 1, WB)
    for i, top in enumerate(tops):
        noisy[i, top:] = rng.integers(0, 1 << 32, WB - top, dtype=np.uint64).astype(np.uint32)
    assert not np.array_equal(noisy, words)
    outs = []
    for w in (words, noisy):
        st = device.from_reference_arrays("cpu", words=w, starts=starts, nseqs=nseqs, tidx=tidx,
                                          tables=tables, logs=logs_t, consts=consts)
        outs.append(entropy.fse_decode_sequences(
            st["words"], st["starts"], st["nseqs"], st["tidx"], st["tables"], st["logs"],
            st["consts"], seq_bound=seq_bound))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    whole = entropy.staged_whole(torch.from_numpy(starts), WB)
    assert whole.tolist() == (tops <= entropy.stage_words(WB)).tolist()
    if name == "wide_rows":
        assert whole.tolist() == [True, False, False, False]
    else:
        assert bool(whole.all())


def test_huffman_batch_equals_reference(blobs):
    for name in ("L3", "libzstd6"):
        stream_list, _sb, _rows = _plans(blobs[name])
        assert stream_list
        got, ob = decode_routes._huf_batch_dev(stream_list, torch.device("cpu"))
        ref, rob = ref_huf_batch_dev(stream_list)
        assert ob == rob
        ref = np.asarray(ref)[: len(stream_list)]
        np.testing.assert_array_equal(got.numpy(), ref)
        for i, (_s, olen, _t) in enumerate(stream_list[:8]):
            assert olen <= ob and got[i, olen:].sum() == 0


def test_bitreach_equals_reference_interpret_kernels(blobs):
    stream_list, _sb, _rows = _plans(blobs["L1"])
    picks = sorted(stream_list, key=lambda s: len(s[0]))[:2]
    got, ob = decode_routes._huf_batch_dev(picks, torch.device("cpu"))
    word_bound = 1 << max(((max(len(s) for s, _, _ in picks) + 3) // 4).bit_length(), 4)
    for i, (sbytes, olen, table) in enumerate(picks):
        words, start = plan._words_from_bytes(sbytes, word_bound)
        sym = np.zeros(2048, np.int32)
        nbits = np.zeros(2048, np.int32)
        size = 1 << table.max_bits
        sym[:size], nbits[:size] = table.symbol, table.nb_bits
        ref, n = ref_hs.decode_stream_bitreach(
            jnp.asarray(words), jnp.int32(start), ob, jnp.asarray(sym), jnp.asarray(nbits),
            jnp.int32(table.max_bits), interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
        out, n_sym = huffman_spec.decode_stream_bitreach(
            torch.from_numpy(words.view(np.int32))[None], torch.tensor([start]), ob,
            torch.from_numpy(sym)[None], torch.from_numpy(nbits)[None],
            torch.tensor([table.max_bits]))
        assert int(n_sym[0]) == int(n) >= olen
