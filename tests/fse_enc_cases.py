"""Cases of the FSE-encode tests, shared by the CPU tests and the card's.

Each case is the inputs of ``fse_kernel.fse_encode`` as numpy arrays:
consts int32[512], meta int32[NRECJ, 8], lm and ofv int32[NREC, SBd]
(``lm`` = ll << 16 | ml, ``ofv`` the repeat-coded offset value), tables
int32[T, 1024], and SBd, WBo. SBd is 8192 (``BLOCK_SIZE // 4``) and WBo
``word_bound(SBd)`` unless noted. All are made from seeds:

- ``level1``, ``level3``: the jobs of a 96 KiB archive of the port at
  levels 1 and 3 (32 KiB frames), as ``archive._fse_kernel_inputs``
  stages them;
- ``nseq``: jobs of 1, 2, K - 1, K, K + 1, 2K + 1 and 8192 sequences (K
  the kernel's chunk, ``fse_kernel.CHUNK``), and jobs of 0 and -3;
- ``rle``: RLE tables (accuracy log 0) on the ll, of and ml streams in
  turn, then on all three;
- ``predefined_shared``: the predefined tables, their rows shared by
  several jobs, and one job sharing only the of row;
- ``code_edges``: ll 0/15/16/63/64/65/32768/65535, ml 3/34/35/130/131/
  65535, ofv 1-3 and 2^k - 1, 2^k up to 2^30;
- ``tidx_out_of_range``: table indices past the pool (the nearest row is
  read); negative indices are left out: the JAX kernel counts them from
  the pool's end, the port reads row 0;
- ``overflow``: WBo = 64, which the longer streams overflow: their words
  stop at WBo and their bit counts are whole.

ml stays at 3 or more (the least match): below it the JAX kernel and the
plain version read the code from outside the ml LUT, the CUDA kernel
from its first entry.

Imports no JAX.
"""

import functools

import numpy as np

from zeekstd_tpu_torch import archive
from zeekstd_tpu_torch.codec import sequences as sq
from zeekstd_tpu_torch.codec.fse import build_encode_table, normalize_counts, optimal_table_log
from zeekstd_tpu_torch.codec.seq_encode import ll_code, ml_code, of_code
from zeekstd_tpu_torch.ops import fse_kernel as fk

CASES = ("level1", "level3", "nseq", "rle", "predefined_shared", "code_edges",
         "tidx_out_of_range", "overflow")
SBD = archive.BLOCK_SIZE // 4
OVERFLOW_WBO = 64


def _text(n, seed=5):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    text = b" ".join(words[rng.integers(0, 200)] for _ in range(n // 5))
    return (text[: n // 2] + b"R" * 3000 + bytes(rng.integers(0, 256, n // 8, dtype=np.uint8))
            + b"xyzw" * 2000 + text[n // 2 :])[:n]


@functools.lru_cache(maxsize=2)
def _archive_call(level):
    """The arguments the level's CPU encode hands ``fse_encode``."""
    calls = []
    orig = fk.fse_encode

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    fk.fse_encode = rec
    try:
        archive.compress_archive(_text(96 << 10), frame_size=32 << 10, level=level,
                                 device="cpu")
    finally:
        fk.fse_encode = orig
    (a, k), = calls
    return tuple(t.numpy() for t in a) + (k["SBd"], k["WBo"])


def _seqs(rng, n):
    """ll, ml, ofv of n sequences, skewed small as parsed text is."""
    u = rng.random(n)
    ll = np.where(u < 0.6, rng.integers(0, 16, n),
                  np.where(u < 0.9, rng.integers(16, 200, n), rng.integers(200, 5000, n)))
    u = rng.random(n)
    ml = np.where(u < 0.7, rng.integers(3, 40, n),
                  np.where(u < 0.95, rng.integers(40, 300, n), rng.integers(300, 20000, n)))
    ofv = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n), 3 + rng.integers(1, 1 << 17, n))
    return ll, ml, ofv


def _codes(ll, ml, ofv):
    return ([ll_code(int(x)) for x in ll], [ml_code(int(x)) for x in ml],
            [of_code(int(x)) for x in ofv])


def _dedicated(codes, max_log, max_code):
    hist = np.bincount(codes, minlength=max_code + 1).astype(np.int64)
    n = int(hist.sum())
    present = int(np.max(np.nonzero(hist)[0]))
    log = optimal_table_log(max_log, n, max_code)
    return build_encode_table(normalize_counts(hist, log, n, present), log)


def _rle(sym):
    return build_encode_table([0] * sym + [1], 0)


def _job(ll, ml, ofv, tables=(None, None, None)):
    """A job of the given sequences; each of ``tables`` (ll, of, ml) left
    None is built from the sequences' own codes."""
    llc, mlc, ofc = _codes(ll, ml, ofv)
    tables = tuple(
        t if t is not None else _dedicated(codes, max_log, max_code)
        for t, codes, max_log, max_code in zip(
            tables, (llc, ofc, mlc), (sq.LL_MAX_LOG, sq.OF_MAX_LOG, sq.ML_MAX_LOG),
            (35, 31, 52)))
    return {"ll": np.asarray(ll), "ml": np.asarray(ml), "ofv": np.asarray(ofv),
            "tables": tables}


def _stage(jobs, WBo=None):
    """Inputs of ``fse_encode`` for ``jobs`` (dicts of ll, ml, ofv, tables;
    or {"nseq": n} for a job without sequences), one record per job, staged
    by ``archive._fse_kernel_inputs``."""
    lm = np.zeros((len(jobs), SBD), np.uint32)
    ofv = np.zeros((len(jobs), SBD), np.int32)
    fse_jobs = []
    for j, job in enumerate(jobs):
        tll, tof, tml = jobs[0]["tables"] if "nseq" in job else job["tables"]
        nseq = job.get("nseq", 0)
        if "nseq" not in job:
            nseq = len(job["ll"])
            lm[j, :nseq] = (job["ll"].astype(np.uint32) << 16) | job["ml"].astype(np.uint32)
            ofv[j, :nseq] = job["ofv"]
        fse_jobs.append({"frame": j, "block": 0, "nseq": nseq,
                         "tables": {"ll": (None, tll), "of": (None, tof), "ml": (None, tml)}})
    meta, tables, _nrecj = archive._fse_kernel_inputs(fse_jobs, 1)
    return (fk.make_consts(), meta, lm.view(np.int32), ofv, tables, SBD,
            WBo or fk.word_bound(SBD))


def _nseq(rng):
    K = fk.CHUNK
    jobs = [_job(*_seqs(rng, n)) for n in (1, 2, K - 1, K, K + 1, 2 * K + 1, SBD)]
    return _stage(jobs + [{"nseq": 0}, {"nseq": -3}])


def _rle_case(rng):
    jobs = []
    for on in ((0,), (1,), (2,), (0, 1, 2)):
        ll, ml, ofv = _seqs(rng, 700)
        if 0 in on:
            ll = rng.integers(64, 128, 700)      # code 25: six extra bits each
        if 1 in on:
            ofv = rng.integers(1 << 9, 1 << 10, 700)  # code 9
        if 2 in on:
            ml = np.full(700, 7)                 # code 4, no extra bits
        llc, mlc, ofc = _codes(ll[:1], ml[:1], ofv[:1])
        jobs.append(_job(ll, ml, ofv, (_rle(llc[0]) if 0 in on else None,
                                       _rle(ofc[0]) if 1 in on else None,
                                       _rle(mlc[0]) if 2 in on else None)))
    return _stage(jobs)


def _predefined_shared(rng):
    pre = (build_encode_table(sq.LL_DEFAULT_NORM, sq.LL_DEFAULT_LOG),
           build_encode_table(sq.OF_DEFAULT_NORM, sq.OF_DEFAULT_LOG),
           build_encode_table(sq.ML_DEFAULT_NORM, sq.ML_DEFAULT_LOG))
    jobs = []
    for n in (300, 1200, 5, 2000, 64):
        ll, ml, ofv = _seqs(rng, n)
        jobs.append(_job(ll, ml, np.minimum(ofv, (1 << 28) - 1), pre))
    return _stage(jobs + [_job(*_seqs(rng, 900), (None, pre[1], None))])


def _code_edges(rng):
    lls = [0, 1, 15, 16, 63, 64, 65, 127, 128, 32767, 32768, 65535]
    mls = [3, 4, 34, 35, 130, 131, 132, 32768, 65535]
    ofvs = [1, 2, 3] + [v for k in range(1, 31) for v in ((1 << k) - 1, 1 << k)]
    n = 3 * len(ofvs) * 4
    ll = np.array([lls[i % len(lls)] for i in range(n)])
    ml = np.array([mls[i % len(mls)] for i in range(n)])
    ofv = np.array([ofvs[i % len(ofvs)] for i in range(n)])
    perm = rng.permutation(n)
    return _stage([_job(ll, ml, ofv), _job(ll[perm], ml[perm], ofv[perm]),
                   _job(ll[perm][:7], ml[perm][:7], ofv[perm][:7])])


def _tidx_out_of_range(rng):
    jobs = [_job(*_seqs(rng, n)) for n in (400, 1500, 30)]
    consts, meta, lm, ofv, tables, SBd, WBo = _stage(jobs)
    T = tables.shape[0]
    tables[T - 1] = tables[meta[1, fk.J_TOF]]  # the row they clamp to: a real table
    meta[0, fk.J_TLL] = T
    meta[1, fk.J_TOF], meta[1, fk.J_TML] = T + 5, 1 << 20
    meta[2, fk.J_TLL], meta[2, fk.J_TOF], meta[2, fk.J_TML] = T, T + 1, (1 << 31) - 1
    return consts, meta, lm, ofv, tables, SBd, WBo


def _overflow(rng):
    jobs = [_job(*_seqs(rng, n)) for n in (3000, 600, 8, 150)]
    return _stage(jobs, WBo=OVERFLOW_WBO)


def case(name):
    """(consts, meta, lm, ofv, tables, SBd, WBo) of case ``name``."""
    if name in ("level1", "level3"):
        return _archive_call(int(name[-1]))
    rng = np.random.default_rng(CASES.index(name) + 70)
    return {"nseq": _nseq, "rle": _rle_case, "predefined_shared": _predefined_shared,
            "code_edges": _code_edges, "tidx_out_of_range": _tidx_out_of_range,
            "overflow": _overflow}[name](rng)
