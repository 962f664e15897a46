"""Seeded inputs for the archive block-size cases (``ZEEKSTD_TPU_BLOCK``).

No JAX here: ``tests/test_torch_blocks.py`` holds the port against the JAX
package on these inputs, and the card tests (``tests/test_torch_gpu.py``)
and ``chip_smoke.py`` phase 8 use them on the card.

- ``text``: 256 KiB of word text, one frame of two 128 KiB blocks;
- ``long_run``: 20 kB of text, 100 kB of random bytes, a 90 kB repeat of
  them (one match longer than 16 bits can hold), then text: a literal run
  of 100 kB and a match of 90 kB, each past 16 bits;
- ``mixed_input(n)``: text, an RLE run, random bytes and "abc" repeats,
  the mixed input of ``chip_smoke.py`` (phases 2, 8 and 9) and of
  ``tests/test_torch_knobs.py`` and the card tests of the route variables.
"""

from __future__ import annotations

import numpy as np

KIB = 1 << 10
BLOCKS = (16 * KIB, 64 * KIB, 128 * KIB)  # the block sizes the cases run at
DEFAULT_BLOCK = 32 * KIB                  # ZEEKSTD_TPU_BLOCK unset
FRAME = 256 * KIB                         # one frame: two blocks at 128 KiB
LEVELS = (1, 3)


def word_text(n: int, seed: int = 11) -> bytes:
    """``n`` bytes of text: 600 seeded phrases of 3-8 words from a
    400-word vocabulary, and single words, in seeded order. About 14,000
    sequences in 256 KiB, so the level-3 parse stays under its sequence
    bound (frame_size / 8) and encodes on the device."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(400)]
    phrases = [b" ".join(words[i] for i in rng.integers(0, 400, rng.integers(3, 9)))
               for _ in range(600)]
    out, total = [], 0
    while total < n:
        piece = (phrases[rng.integers(0, 600)] if rng.random() < 0.7
                 else words[rng.integers(0, 400)])
        out.append(piece)
        total += len(piece) + 1
    return b" ".join(out)[:n]


def long_run(n: int = 256 * KIB, seed: int = 12) -> bytes:
    """Text, 100 kB of random bytes, a 90 kB repeat of them, then text: the
    first ``n`` bytes."""
    rng = np.random.default_rng(seed)
    rand = bytes(rng.integers(0, 256, 100_000, dtype=np.uint8))
    head = word_text(20_000, seed + 1)
    body = head + rand + rand[:90_000]
    return (body + word_text(max(n - len(body), 0), seed + 2))[:n]


def mixed_input(n: int, seed: int = 7) -> bytes:
    """Text, an RLE run, random bytes and overlapping "abc" repeats: the
    first ``n`` bytes."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    text = b" ".join(words[rng.integers(0, 200)] for _ in range(n // 5))
    q = n // 4
    return (text[: 2 * q] + b"A" * (q // 4) + bytes(rng.integers(0, 256, q, dtype=np.uint8))
            + b"abcabcabc" * n)[:n]


INPUTS = {"text": word_text(256 * KIB), "long_run": long_run()}
