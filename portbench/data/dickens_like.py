"""English-like text from a seed, tuned to Silesia dickens' compressed share:
a fixed vocabulary of 20,000 words spelt from English letter frequencies
(vocabulary seed 1898), drawn by Zipf's law with the exponent ``ZIPF``, in
sentences of 6-25 words, with paragraph and chapter breaks. Only the text
drawn from the vocabulary depends on ``seed``, so every seed makes the same
kind of text.

``ZIPF`` was chosen so that libzstd at level 3 (its default) stores about
36% of the text in 2 MiB frames, the share the repository gives for dickens;
python-zstandard 0.25 reads 35.91% at level 3 and 38.49% at level 1 on 10,192,446
bytes of seed 7 (``python3 -m portbench.data.dickens_like`` prints them)."""

from __future__ import annotations

import numpy as np

VOCAB_SEED = 1898
VOCAB_WORDS = 20000
ZIPF = 1.39
LETTERS = "etaoinshrdlcumwfgypbvkjxqz"
LETTER_PCT = (12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
              2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07)
ENDS = (". ", ". ", "; ", ", and ", "? ", ", ")

_VOCAB: list[str] = []


def vocabulary() -> list[str]:
    """The fixed word list, most frequent first: 2-16 letters, the short
    words leading, as in English."""
    if not _VOCAB:
        r = np.random.default_rng(VOCAB_SEED)
        p = np.array(LETTER_PCT) / sum(LETTER_PCT)
        letters = np.array(list(LETTERS))
        seen: set[str] = set()
        for n in np.clip(r.poisson(5.0, VOCAB_WORDS) + 2, 2, 16):
            w = "".join(letters[r.choice(26, n, p=p)])
            if w not in seen:
                seen.add(w)
                _VOCAB.append(w)
        _VOCAB.sort(key=lambda w: len(w) + 3.0 * r.random())
    return _VOCAB


def generate(size: int, seed: int) -> bytes:
    words = vocabulary()
    r = np.random.default_rng(seed % 2**64)
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -ZIPF)
    cdf /= cdf[-1]
    out: list[str] = []
    total = 0
    while total < size:
        # A batch of sentences; every draw comes from ``r`` in one order.
        n = max(64, (size - total) // 80)
        lengths = r.integers(6, 26, n)
        tokens = np.searchsorted(cdf, r.random(int(lengths.sum())))
        ends = r.integers(0, len(ENDS), n)
        breaks = r.random(n)
        chapters = r.integers(1, 60, n)
        pos = 0
        for k in range(n):
            text = " ".join(words[t] for t in tokens[pos:pos + lengths[k]])
            pos += lengths[k]
            text = text.capitalize() + ENDS[ends[k]]
            if breaks[k] < 0.02:
                text = f"\n\nCHAPTER {chapters[k]}.\n\n" + text
            elif breaks[k] < 0.12:
                text = "\n\n" + text
            out.append(text)
            total += len(text)
            if total >= size:
                break
    return "".join(out).encode()[:size]


if __name__ == "__main__":
    import zstandard

    data = generate(10_192_446, 7)
    for level in (1, 3):
        c = zstandard.ZstdCompressor(level=level)
        stored = sum(len(c.compress(data[i:i + 2**21])) for i in range(0, len(data), 2**21))
        print(f"level {level}: {100 * stored / len(data):.2f}%")
