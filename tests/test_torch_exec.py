"""PyTorch port: the serial sequence executor against the JAX package.

- ``build_records`` equals the reference's record tables.
- ``exec_plain`` (the CUDA kernel's plain version) equals the byte-serial
  reference of ``tests/test_exec_kernel.py`` on its twelve cases: repeat
  offsets threaded across blocks, overlapped matches, a match crossing a
  128-byte row, raw/RLE records, trailing literals, block slicing, a bad
  offset, multi-frame batches.
- ``exec_plain`` equals the JAX Pallas kernel in interpret mode (bytes
  over [0, total) and the three meta lanes) on three of those inputs.

The cases (``CASES``, ``case_args``) import no JAX: ``test_torch_gpu.py``
runs them through the CUDA executor on the card.
"""

import numpy as np
import pytest
import torch

from zeekstd_tpu_torch.ops import exec_kernel as ek

from .torch_threads import two_torch_threads  # noqa: F401

LITB = 2048


@pytest.fixture(scope="module")
def ref():
    """The JAX package's executor module and its tests' byte-serial
    reference and interpret-mode runner (``tests/test_exec_kernel.py``)."""
    pytest.importorskip("jax")
    from zeekstd_tpu.ops import exec_kernel as ref_ek

    from . import test_exec_kernel

    return ref_ek, test_exec_kernel


def seq_rows(seqs_per_row, width=None):
    """seqs_per_row: list of lists of (ll, ml, ofv) (a copy of
    ``tests/test_exec_kernel.seq_rows``)."""
    width = width or max(max((len(r) for r in seqs_per_row), default=1), 8)
    n = len(seqs_per_row)
    ll = np.zeros((n, width), np.int32)
    ml = np.zeros((n, width), np.int32)
    ofv = np.zeros((n, width), np.int32)
    for i, r in enumerate(seqs_per_row):
        for j, (a, b, c) in enumerate(r):
            ll[i, j], ml[i, j], ofv[i, j] = a, b, c
    return ll, ml, ofv


def _lits_tensor(lits_list, litb=LITB):
    lrws = litb // 128 + 1
    max_lit = max((len(x) for x in lits_list), default=0)
    lrows = -(-max_lit // 128) + lrws
    lits = np.zeros((len(lits_list), lrows * 128), np.int32)
    for i, x in enumerate(lits_list):
        lits[i, : len(x)] = np.frombuffer(bytes(x), np.uint8)
    return torch.from_numpy(lits.reshape(len(lits_list), lrows, 128))


def run_plain(meta, ll, ml, ofv, lits_list, OUTB, SBd):
    out, meta_out = ek.exec_plain(
        torch.from_numpy(meta), torch.from_numpy(ll), torch.from_numpy(ml),
        torch.from_numpy(ofv), _lits_tensor(lits_list), OUTB, LITB, SBd)
    return out.reshape(len(lits_list), OUTB).numpy(), meta_out.numpy()


def _random_frames(rng):
    """One trial of test_exec_kernel.test_multi_frame_random."""
    F = int(rng.integers(1, 4))
    rows, frames, lits_list = [], [], []
    for _f in range(F):
        blocks, lit_stream, pos = [], bytearray(), 0
        for _b in range(int(rng.integers(1, 4))):
            pick = rng.integers(0, 10)
            if pick < 1:
                n = int(rng.integers(1, 200))
                blocks.append(("rle", n, int(rng.integers(0, 256))))
                pos += n
            elif pick < 3:
                n = int(rng.integers(0, 300))
                lit_stream += bytes(rng.integers(0, 256, n, dtype=np.uint8))
                blocks.append(("lit", n))
                pos += n
            else:
                seqs, used, reps = [], 0, [1, 4, 8]
                for _ in range(int(rng.integers(1, 30))):
                    ll = int(rng.integers(0, 24)) or (1 if pos == 0 else 0)
                    lit_stream += bytes(rng.integers(0, 256, ll, dtype=np.uint8))
                    used += ll
                    pos += ll
                    ml = int(rng.integers(3, 40))
                    r1, r2, r3 = reps
                    ofv = int(rng.integers(1, 4))
                    ridx = ofv + (1 if ll == 0 else 0)
                    cand = {1: r1, 2: r2, 3: r3, 4: r1 - 1}[ridx]
                    if rng.random() < 0.4 and 0 < cand <= pos:
                        reps = {1: reps, 2: [r2, r1, r3], 3: [r3, r1, r2],
                                4: [r1 - 1, r1, r2]}[ridx]
                    else:
                        off = int(rng.integers(1, pos + 1))
                        ofv = off + 3
                        reps = [off, r1, r2]
                    seqs.append((ll, ml, ofv))
                    pos += ml
                trail = int(rng.integers(0, 50))
                lit_stream += bytes(rng.integers(0, 256, trail, dtype=np.uint8))
                pos += trail
                blocks.append(("seq", len(rows), len(seqs), used + trail))
                rows.append(seqs)
        frames.append(blocks)
        lits_list.append(bytes(lit_stream))
    ll, ml, ofv = seq_rows(rows or [[]], width=32)
    return frames, ll, ml, ofv, lits_list, 8192, 32


def _slicing_case():
    rng = np.random.default_rng(7)
    lits = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    seqs, pos = [], 0
    for _ in range(20):
        ll = int(rng.integers(1, 20))
        pos += ll
        ml = int(rng.integers(3, 12))
        seqs.append((ll, ml, int(rng.integers(1, pos + 1)) + 3))
        pos += ml
    budget = sum(s[0] for s in seqs) + 10
    ll, ml, ofv = seq_rows([seqs], width=32)
    # Sliced: the (1, 32) row repacked as (4, 8), executed at SBd = 8.
    return ([[("seq", 0, 20, budget)]], ll.reshape(4, 8), ml.reshape(4, 8),
            ofv.reshape(4, 8), [lits], 4096, 8)


def _case(name):
    """(frames_blocks, ll, ml, ofv, lits_list, OUTB, SBd) of the reference
    test of the same name."""
    one = lambda seqs, blocks, lits: (blocks, *seq_rows(seqs), lits, 4096, None)  # noqa: E731
    if name == "literals_only":
        lits = bytes(range(256)) * 2
        return one([[]], [[("lit", len(lits))]], [lits])
    if name == "rle_block":
        return one([[]], [[("rle", 300, 0x5A)]], [b""])
    if name == "simple_match":
        return one([[(8, 5, 11)]], [[("seq", 0, 1, 8)]], [b"abcdefgh"])
    if name == "overlapped_match_rle_style":
        return one([[(1, 500, 4)]], [[("seq", 0, 1, 1)]], [b"x"])
    if name == "overlap_period_three":
        return one([[(3, 400, 6), (0, 0, 0)]], [[("seq", 0, 1, 7)]], [b"abcRest"])
    if name == "cross_row_boundary_match":
        return one([[(131, 130, 133)]], [[("seq", 0, 1, 131)]], [bytes(range(131))])
    if name == "repeat_offsets_full_matrix":
        seqs = [(10, 4, 7), (5, 3, 1), (5, 3, 2), (0, 3, 1), (0, 3, 3), (5, 3, 3), (5, 3, 8)]
        return one([seqs], [[("seq", 0, len(seqs), 30)]], [b"0123456789" * 4])
    if name == "rep_carry_across_blocks":
        return one([[(10, 6, 10)], [(0, 4, 1), (5, 4, 2)]],
                   [[("seq", 0, 1, 10), ("seq", 1, 2, 5)]], [b"abcdefghij" + b"KLMNO"])
    if name == "rep_history_through_raw_and_rle_blocks":
        return one([[(10, 5, 9)], [(0, 4, 1)]],
                   [[("seq", 0, 1, 10), ("lit", 13), ("rle", 7, 0x41), ("seq", 1, 1, 0)]],
                   [b"0123456789" + b"rawblockbytes"])
    if name == "block_slicing_matches_unsliced":
        return _slicing_case()
    if name == "bad_offset_flagged":
        return one([[(3, 4, 103)]], [[("seq", 0, 1, 3)]], [b"abc"])
    raise KeyError(name)


CASES = [
    "literals_only", "rle_block", "simple_match", "overlapped_match_rle_style",
    "overlap_period_three", "cross_row_boundary_match", "repeat_offsets_full_matrix",
    "rep_carry_across_blocks", "rep_history_through_raw_and_rle_blocks",
    "block_slicing_matches_unsliced", "bad_offset_flagged", "multi_frame_random",
]


def case_inputs(name):
    """The inputs of case ``name``: [(frames_blocks, ll, ml, ofv,
    lits_list, OUTB, SBd)], SBd resolved (four seeded trials for
    multi_frame_random)."""
    if name == "multi_frame_random":
        rng = np.random.default_rng(42)
        cases = [_random_frames(rng) for _ in range(4)]
    else:
        cases = [_case(name)]
    return [(frames, ll, ml, ofv, lits_list, OUTB, SBd or ll.shape[1])
            for frames, ll, ml, ofv, lits_list, OUTB, SBd in cases]


def case_args(name):
    """Case ``name`` as ``serial_exec`` calls: [(args on the CPU, kwargs)]."""
    calls = []
    for frames, ll, ml, ofv, lits_list, OUTB, SBd in case_inputs(name):
        meta, _n = ek.build_records(frames, SBd)
        args = [torch.from_numpy(a) for a in (meta, ll, ml, ofv)] + [_lits_tensor(lits_list)]
        calls.append((args, dict(OUTB=OUTB, LITB=LITB, SBd=SBd)))
    return calls


@pytest.mark.parametrize("frames", [
    [[("lit", 5)], []],
    [[("seq", 0, 20, 40), ("rle", 7, 65), ("seq", 3, 5, 9)], [("lit", 0)]],
    [[("seq", 2, 8, 8), ("seq", 3, 9, 1), ("lit", 300)]],
])
@pytest.mark.parametrize("sbd", [8, 32])
def test_build_records_matches_reference(ref, frames, sbd):
    ref_ek, _ = ref
    got, n = ek.build_records(frames, sbd)
    want, rn = ref_ek.build_records(frames, sbd)
    assert n == rn
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_exec_plain_equals_byte_serial_reference(ref, name):
    ref_execute = ref[1].ref_execute
    for frames, ll, ml, ofv, lits_list, OUTB, SBd in case_inputs(name):
        meta, n_rec = ek.build_records(frames, SBd)
        exp, bads, litcs = ref_execute(meta, ll, ml, ofv, lits_list, n_rec, len(lits_list))
        out, meta_out = run_plain(meta, ll, ml, ofv, lits_list, OUTB, SBd)
        for f in range(len(lits_list)):
            total = meta_out[f, 0]
            assert total == len(exp[f])
            assert meta_out[f, 1] == bads[f]
            assert meta_out[f, 2] == litcs[f]
            assert bytes(out[f, :total]) == exp[f]


@pytest.mark.parametrize("name", ["cross_row_boundary_match", "repeat_offsets_full_matrix",
                                  "rep_history_through_raw_and_rle_blocks"])
def test_exec_plain_equals_interpret_kernel(ref, name):
    (frames, ll, ml, ofv, lits_list, OUTB, SBd), = case_inputs(name)
    meta, _n = ek.build_records(frames, SBd)
    out, meta_out = run_plain(meta, ll, ml, ofv, lits_list, OUTB, SBd)
    ref_out, ref_meta = ref[1].run_kernel(meta, ll, ml, ofv, lits_list, OUTB, SBd, LITB)
    np.testing.assert_array_equal(meta_out[:, :3], ref_meta[:, :3])
    for f in range(len(lits_list)):
        total = meta_out[f, 0]
        np.testing.assert_array_equal(out[f, :total], ref_out[f, :total])


def test_exec_wrapper_checks_shapes():
    frames, ll, ml, ofv, lits_list, OUTB, _ = _case("simple_match")
    meta, _n = ek.build_records(frames, 8)
    args = [torch.from_numpy(a) for a in (meta, ll, ml, ofv)] + [_lits_tensor(lits_list)]
    with pytest.raises(ValueError):
        ek.serial_exec(*args, OUTB=1000, LITB=LITB, SBd=8)
    with pytest.raises(ValueError):
        ek.serial_exec(*args, OUTB=OUTB, LITB=LITB * 4, SBd=8)
    out, meta_out = ek.serial_exec(*args, OUTB=OUTB, LITB=LITB, SBd=8)
    assert bytes(out.reshape(-1)[:13].numpy()) == b"abcdefghabcde"
    assert meta_out[0, :3].tolist() == [13, 0, 8]
