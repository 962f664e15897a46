"""Seeded cases of the byte histogram and the table lookup, shared by the
CPU tests (against the JAX kernels in interpret mode,
``test_torch_bytes.py``) and the card tests (against the plain versions,
``test_torch_gpu.py``). Imports no JAX.

``HIST[name]`` is (uint8 data, block); ``LOOKUP[name]`` is (uint8 data,
table), the table a numpy array of any integer dtype, possibly a strided
view.
"""

import numpy as np

import chip_smoke

KIB = 1 << 10
MIB = 1 << 20
I32 = np.iinfo(np.int32)


def _text(n):
    """The first n bytes of chip_smoke.py's 10 MiB text."""
    return np.frombuffer(chip_smoke.build_corpus(n), np.uint8).copy()


def _hist_cases(text):
    rng = np.random.default_rng(11)
    text = text[: 256 * KIB]
    equal = rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), 256))  # 64 KiB
    skewed = rng.integers(0, 256, 96 * KIB).astype(np.uint8)
    skewed[: 40 * KIB] = 0x20
    return {
        "text-256k-block-32k": (text, 32 * KIB),
        "text-block-128": (text[: 16 * KIB], 128),
        "one-byte-block-32k": (np.full(256 * KIB, 0x20, np.uint8), 32 * KIB),
        # One bin takes a whole 1 MiB block: any 8-bit counter must flush.
        "one-byte-block-1m": (np.full(MIB, 0xAB, np.uint8), MIB),
        "all-values-equal-block-8k": (equal, 8 * KIB),
        "skewed-block-8k": (skewed, 8 * KIB),
        "random-n-eq-block-32k": (rng.integers(0, 256, 32 * KIB).astype(np.uint8), 32 * KIB),
        # 48 KiB blocks: a cluster of two CTAs with a partial second round.
        "text-block-48k": (text[: 192 * KIB], 48 * KIB),
    }


def _lookup_cases(text):
    rng = np.random.default_rng(12)
    extremes = rng.integers(I32.min, I32.max, 256, dtype=np.int64, endpoint=True)
    extremes[:4] = [I32.min, I32.max, -1, 0]
    extremes[0x20], extremes[ord("e")] = I32.max, I32.min
    extremes = extremes.astype(np.int32)
    wide = rng.integers(I32.min, I32.max, 512, dtype=np.int64).astype(np.int32)
    return {
        "text-1024": (text[:1024], extremes),
        "text-3072": (text[: 3 * 1024], extremes),
        "text-1m": (text, extremes),
        "random-1m": (rng.integers(0, 256, MIB).astype(np.uint8), extremes),
        "uint8-table": (text[: 64 * KIB], rng.integers(0, 256, 256).astype(np.uint8)),
        "int16-table": (text[: 64 * KIB], rng.integers(-(1 << 15), 1 << 15, 256).astype(np.int16)),
        "int64-table": (text[: 64 * KIB], extremes.astype(np.int64)),
        "strided-table": (text[: 64 * KIB], wide[::2]),
    }


_TEXT = _text(MIB)
HIST = _hist_cases(_TEXT)
LOOKUP = _lookup_cases(_TEXT)
