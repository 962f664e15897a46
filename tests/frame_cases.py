"""Inputs of the per-frame device encoder's tests, shared by the CPU tests
(``test_torch_frame_codec.py``, against the JAX package) and the card tests
(``test_torch_gpu.py``). Imports no JAX.

The cases of ``tests/test_tpu_codec.py`` (its generators, from
``tests/test_decompress.py``, copied here; ``structured_data`` in linear
time, same bytes), and two whose 128 KiB blocks hold lengths past 16
bits: a literal run of 100 kB (random bytes, then text) and a match of
128 KiB (zeros).
"""

import random


def text_data(n):
    base = (
        b"It was the best of times, it was the worst of times, it was the age "
        b"of wisdom, it was the age of foolishness, it was the epoch of belief. "
    )
    return (base * (n // len(base) + 1))[:n]


def structured_data(n):
    rng = random.Random(42)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon" * 3, b"zeta"]
    parts, total = [], 0
    while total < n:
        w, b = rng.choice(words), bytes([rng.randrange(4)])
        parts += (w, b)
        total += len(w) + 1
    return b"".join(parts)[:n]


def random_data(n, seed=0):
    rng = random.Random(seed)
    return bytes(rng.randrange(256) for _ in range(n))


CASES = {
    "text": text_data(60_000),
    "struct": structured_data(80_000),
    "random": random_data(20_000),
    "zeros": b"\x00" * 50_000,
    "periodic": (b"0123456789abcdef" * 5000)[:70_000],
    "tiny": b"hello",
    "multiblock": structured_data(300_000),
    "long_literals": random_data(100_000, seed=4) + text_data(60_000),
    "long_match": b"\x00" * 200_000,
}
