"""PyTorch port: the native sequence-table chooser (``native/fse_choice``)
against the verbatim ``codec/seq_encode._choose_table``.

Every choice the library makes must be the Python function's: mode,
accuracy log, normalised counts, description bytes and the three encode
table arrays, with the Repeat chain run frame by frame as
``archive._host_jobs`` runs it. Archives must be byte-identical with the
library and with the Python loop forced.
"""

import numpy as np
import pytest

from zeekstd_tpu_torch import _build, archive
from zeekstd_tpu_torch.codec import sequences as seq_mod
from zeekstd_tpu_torch.codec.fse import normalize_counts, optimal_table_log
from zeekstd_tpu_torch.codec.seq_encode import _choose_table
from zeekstd_tpu_torch.native import fse_choice as fc

from .torch_threads import two_torch_threads  # noqa: F401

CATS = fc.CATS  # (name, predefined norm, predefined log, max code, max log)
WIDTH = [mc + 1 for *_r, mc, _ml in CATS]


def _reference(frames, hists):
    """The loop of ``_host_jobs`` over the verbatim function."""
    prev = {}
    out = []
    for j, f in enumerate(frames):
        row = []
        for c, (cat, norm, log, max_code, max_log) in enumerate(CATS):
            p = prev.get((f, cat))
            ch = _choose_table(None, cat, norm, log, max_code, max_log, prev_table=p,
                               hist=hists[c][j])
            if ch[0] != seq_mod.MODE_REPEAT:
                prev[(f, cat)] = ch[1]
            row.append(ch)
        out.append(row)
    return out


def _assert_same(got, ref):
    """Choices per block equal (a Repeat's table is the caller's); returns
    the number of blocks the library left to Python."""
    assert len(got) == len(ref)
    for j, (g_row, r_row) in enumerate(zip(got, ref)):
        if g_row is None:
            continue
        for c, (g, r) in enumerate(zip(g_row, r_row)):
            where = (j, CATS[c][0])
            assert g[0] == r[0], where
            if r[0] == seq_mod.MODE_REPEAT:
                assert g[1] is None and g[2] == b"", where
                continue
            assert g[2] == r[2], where
            gt, rt = g[1], r[1]
            assert gt.accuracy_log == rt.accuracy_log, where
            assert gt.norm == rt.norm and len(gt.norm) == len(rt.norm), where
            for k in ("delta_nb_bits", "delta_find_state", "state_table"):
                a, b = getattr(gt, k), getattr(rt, k)
                assert a.dtype == b.dtype, (where, k)
                np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")
    return sum(row is None for row in got)


def _check(frames, hists, deferred=0):
    frames = np.asarray(frames, np.int64)
    hists = [np.asarray(h, np.int64).reshape(len(frames), w) for h, w in zip(hists, WIDTH)]
    got = fc.choose_tables(frames, *hists)
    ref = _reference(frames.tolist(), hists)
    assert _assert_same(got, ref) == deferred
    return got, ref


def _hist(width, pairs):
    h = np.zeros(width, np.int64)
    for s, c in pairs.items():
        h[s] = c
    return h


def _plain(n=1):
    """Histograms that price every mode apart."""
    return ([_hist(36, {0: 40, 1: 25, 3: 9, 7: 2})] * n, [_hist(32, {1: 12, 5: 30, 9: 3})] * n,
            [_hist(53, {0: 50, 2: 11, 8: 7, 20: 1})] * n)


def _leftover(h, log):
    """The sign of ``normalize_counts``' leftover for a dedicated table."""
    n = int(h.sum())
    size, low = 1 << log, n >> log
    big = [int(c) for c in h if c > low]
    slots = size - sum(1 for c in h if 0 < c <= low)
    rest = sum(big)
    return np.sign(slots - sum(max(int(c * slots / rest), 1) for c in big))


@pytest.fixture(scope="module", autouse=True)
def library():
    if not fc.available():
        pytest.fail("the native chooser did not build")


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_histograms(seed):
    rng = np.random.default_rng(1000 + seed)
    J = 400
    frames = np.sort(rng.integers(0, 12, J))
    hists = []
    for w in WIDTH:
        h = np.zeros((J, w), np.int64)
        for j in range(J):
            k = int(rng.integers(1, w + 1))
            span = w if rng.random() < 0.3 else min(w, 29)
            syms = rng.choice(span, min(k, span), replace=False)
            h[j, syms] = rng.integers(0, int(rng.choice([2, 4, 40, 400, 4000])), len(syms))
            h[j, syms] **= int(rng.integers(1, 3))
            if h[j].sum() == 0:
                h[j, syms[0]] = 1
        hists.append(h)
    got, ref = _check(frames, hists)
    modes = {ch[0] for row in ref for ch in row}
    assert modes == {0, 1, 2, 3}


@pytest.mark.parametrize("case", [
    "rle", "of_beyond_predefined", "minus_one", "leftover_pos", "leftover_neg",
    "repeat_is_predefined", "predefined_fse_exact_tie",
])
def test_cases(case):
    ll, of, ml = _plain()
    if case == "rle":
        ll, of, ml = [_hist(36, {7: 100})], [_hist(32, {0: 3})], [_hist(53, {52: 1})]
        got, ref = _check([0], [ll, of, ml])
        assert [ch[0] for ch in ref[0]] == [seq_mod.MODE_RLE] * 3
        assert [ch[2] for ch in got[0]] == [bytes([7]), bytes([0]), bytes([52])]
        return
    if case == "of_beyond_predefined":
        of = [_hist(32, {3: 5, 29: 1, 31: 2})]  # the predefined table ends at 28
        _, ref = _check([0], [ll, of, ml])
        assert ref[0][1][0] == seq_mod.MODE_FSE
        return
    if case == "minus_one":
        ml = [_hist(53, {0: 9000, 4: 1, 9: 2, 30: 1, 52: 3})]
        _, ref = _check([0], [ll, of, ml])
        assert ref[0][2][0] == seq_mod.MODE_FSE and -1 in ref[0][2][1].norm
        return
    if case in ("leftover_pos", "leftover_neg"):
        # Over-assigned: 15 counts of 4 round below one cell at log 7 and
        # are raised to one, beside 16 counts of 1 at -1; the cell comes off
        # the first of two equal counts.
        h = (_hist(36, {0: 77, 1: 55, 2: 33, 5: 21, 9: 13}) if case == "leftover_pos"
             else _hist(36, {0: 210, 1: 210, **{s: 4 for s in range(2, 17)},
                             **{s: 1 for s in range(17, 33)}}))
        log = optimal_table_log(9, int(h.sum()), 35)
        assert _leftover(h, log) == (1 if case == "leftover_pos" else -1)
        _, ref = _check([0], [[h], of, ml])
        assert ref[0][0][0] == seq_mod.MODE_FSE
        assert case == "leftover_pos" or ref[0][0][1].norm[:2] == [48, 49]
        return
    if case == "repeat_is_predefined":
        # Block 0 picks the predefined table; block 1, the same histogram,
        # prices Repeat of it exactly as the predefined mode, which wins.
        ll = [_hist(36, {0: 1, 1: 1, 2: 1})] * 2
        _, ref = _check([0, 0], [ll, of * 2, ml * 2])
        assert [r[0][0] for r in ref] == [seq_mod.MODE_PREDEFINED] * 2
        return
    # Every price a whole number: predefined and FSE tie exactly at 88 bits.
    ml = [_hist(53, {0: 4, 1: 4, 23: 4, 24: 4})]
    _, ref = _check([0], [ll, of, ml])
    assert ref[0][2][0] == seq_mod.MODE_PREDEFINED and ref[0][2][3] == 88.0


def test_near_tie_leaves_the_frame_to_python():
    """A table at log 7 with counts 8 and 6 prices symbols 0 and 1 as the
    predefined one does (4 and 6 - log2 3 bits) up to rounding: that frame
    goes to Python, the next frame stays native."""
    prev = _hist(36, dict(enumerate([24, 18] + [38] * 9)))
    near = _hist(36, {0: 1, 1: 1})
    ll = [prev, near, prev, _hist(36, {0: 5, 1: 3})]
    ol, mls = _plain(4)[1:]
    got, ref = _check([0, 0, 1, 1], [ll, ol, mls], deferred=2)
    assert got[0] is None and got[1] is None and got[2] is not None
    assert ref[0][0][1].norm[:2] == [8, 6] and ref[1][0][0] == seq_mod.MODE_PREDEFINED


def test_repeat_chains_reset_at_frame_boundaries():
    ll, of, ml = _plain(7)
    got, ref = _check([0, 0, 0, 1, 1, 3, 3], [ll, of, ml])
    for j in (0, 3, 5):  # the first block of a frame never repeats
        assert all(ch[0] != seq_mod.MODE_REPEAT for ch in ref[j])
    for j in (1, 2, 4, 6):
        assert [ch[0] for ch in ref[j]] == [seq_mod.MODE_REPEAT] * 3
        assert [ch[0] for ch in got[j]] == [seq_mod.MODE_REPEAT] * 3


@pytest.mark.parametrize("case", ["degenerate", "no_slots", "random"])
def test_normalize_counts(case):
    rng = np.random.default_rng(7)
    if case == "degenerate":  # every count at or under total >> log
        trials = [(np.array([3, 0, 1, 2, 3]), 5, 1000, 4)]
    elif case == "no_slots":  # more -1 entries than cells
        trials = [(np.ones(40, np.int64), 5, 4000, 39)]
    else:
        trials = []
        for _ in range(300):
            m = int(rng.integers(1, 64))
            counts = rng.integers(0, 500, m) * (rng.random(m) < 0.6)
            counts[-1] = max(counts[-1], 1)
            log = int(rng.integers(5, 10))
            total = int(counts.sum()) * int(rng.choice([1, 1, 1, 3]))
            trials.append((counts, log, total, m - 1))
    for counts, log, total, max_symbol in trials:
        try:
            want = normalize_counts(counts.astype(np.int64), log, total, max_symbol)
        except Exception:
            want = None
        assert fc.normalize(counts, log, total, max_symbol) == want


def _captured(gen, level, monkeypatch):
    seen = []
    real = archive._host_jobs

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(archive, "_host_jobs", spy)
    data = gen.generate(384 << 10, 20240607)
    archive.compress_archive(data, frame_size=128 << 10, level=level, checksum=True,
                             device="cpu")
    (F, _lengths, overflow, seq_cnt, _fi, _lc, ll_hist, ml_hist, of_hist, _lh), = seen
    keep = [(f, b) for f in range(F) if not overflow[f]
            for b in range(seq_cnt.shape[1]) if seq_cnt[f, b] > 0]
    fi, bi = (np.array(x) for x in zip(*keep))
    return fi, [ll_hist[fi, bi], of_hist[fi, bi], ml_hist[fi, bi]]


# English text at level 3 makes more sequences than the parse's bound (one
# per 8 bytes), so every dickens_like frame there is encoded on the host and
# none of its blocks reaches the choice.
@pytest.mark.parametrize("gen_name,level", [
    ("dickens_like", 1), ("hdfs_v1_like", 1), ("hdfs_v1_like", 3),
])
def test_generator_histograms(gen_name, level, monkeypatch):
    from portbench.data import dickens_like, hdfs_v1_like

    gen = {"dickens_like": dickens_like, "hdfs_v1_like": hdfs_v1_like}[gen_name]
    frames, hists = _captured(gen, level, monkeypatch)
    assert len(frames) >= 10
    _check(frames, hists)


def _archive_data():
    rng = np.random.default_rng(55)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    text = b" ".join(words[rng.integers(0, 200)] for _ in range(16000))
    return (text[:40000] + b"R" * 3000 + bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
            + b"abcabcabc" * 1000 + text[40000:])[: 88 << 10]


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("checksum", [False, True])
def test_archives_equal_with_the_python_loop(level, checksum, monkeypatch):
    data = _archive_data()
    blocks, py_calls = [], []
    choose_tables, choose_table = fc.choose_tables, archive._choose_table

    def tables_spy(frames, *hists):
        blocks.append(len(frames))
        return choose_tables(frames, *hists)

    def table_spy(*args, **kwargs):
        py_calls.append(args[1])
        return choose_table(*args, **kwargs)

    monkeypatch.setattr(fc, "choose_tables", tables_spy)
    monkeypatch.setattr(archive, "_choose_table", table_spy)

    def encode():
        """The archive, its sequence blocks and its ``_choose_table`` calls."""
        blocks.clear()
        py_calls.clear()
        out = archive.compress_archive(data, frame_size=32 << 10, level=level,
                                       checksum=checksum, device="cpu")
        return out, sum(blocks), len(py_calls)

    (blob, st), n_blocks, n_py = encode()
    assert n_blocks > 0
    assert n_py == 0
    monkeypatch.setattr(fc, "_get_lib", lambda: None)
    (blob_py, st_py), n_blocks_py, n_py_forced = encode()
    assert n_blocks_py == n_blocks
    assert n_py_forced == 3 * n_blocks
    assert blob == blob_py
    assert st.to_bytes() == st_py.to_bytes()
    assert archive.decompress_archive(blob, st, device="cpu") == data


def test_failed_build_falls_back(monkeypatch):
    def fail(*_a, **_k):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(fc, "_lib", None)
    monkeypatch.setattr(fc, "_build_failed", False)
    monkeypatch.setattr(_build, "load", fail)
    assert not fc.available()
    ll, of, ml = _plain(2)
    assert fc.choose_tables(np.zeros(2, np.int64), np.stack(ll), np.stack(of),
                            np.stack(ml)) == [None, None]
