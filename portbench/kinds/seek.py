"""One long-lived ``Decoder`` over an archive written once at set-up, read a
record at a time: each read is ``seek`` to a record's offset, then ``read``
of its length, and each is one timed call.

The records are the configuration generator's ``layout(size)``, the same
for every seed, and the mix draws them as YCSB's workload C draws keys
(read-only, ``ScrambledZipfianGenerator``) from its own ``query_seed``. So
every run makes the same list of reads, round after round, on the bytes of
its own seed. The list is turned so that its first read starts in another
frame than the one its last read ends in: every round, the warm one too,
then makes the same frame loads and cache hits."""

from __future__ import annotations

import importlib

import numpy as np

from portbench import driver

# YCSB's ScrambledZipfianGenerator: ranks over its ITEM_COUNT (10^10) items
# by ZipfianGenerator (Gray et al., SIGMOD 1994) with zeta(ITEM_COUNT, 0.99)
# precomputed as ZETAN, then hashed (FNV-64) onto the records.
ITEMS = 10_000_000_000 + 1  # ZipfianGenerator(0, ITEM_COUNT): max - min + 1
ZETAN = 26.46902820178302
YCSB_CONSTANT = 0.99


def zipf_ranks(r, n: int, theta: float) -> list[int]:
    """``n`` ranks of ``ZipfianGenerator.nextValue()``."""
    if theta != YCSB_CONSTANT:
        raise ValueError("YCSB's scrambled Zipfian fixes its constant at 0.99")
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / ITEMS) ** (1 - theta)) / (1 - (1 + 0.5 ** theta) / ZETAN)
    u = r.random(n)
    ranks = np.floor(ITEMS * (eta * u - eta + 1) ** alpha).astype(np.int64)
    ranks[u * ZETAN < 1 + 0.5 ** theta] = 1
    ranks[u * ZETAN < 1] = 0
    return ranks.tolist()


def fnv64(value: int) -> int:
    """YCSB's ``Utils.fnvhash64``: FNV-1a over the value's eight bytes, low
    first, as a non-negative Java long."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h = ((h ^ (value & 0xFF)) * 1099511628211) & (2**64 - 1)
        value >>= 8
    return abs(h - 2**64 if h >= 2**63 else h)


def queries(mix: dict, records: int) -> list[int]:
    """The records of one round, by index, from the mix's ``query_seed``."""
    r = np.random.default_rng(mix["query_seed"])
    ranks = zipf_ranks(r, mix["reads_per_round"], mix["zipf_constant"])
    return [fnv64(k) % records for k in ranks]


def turned(reads: list[tuple[int, int]], frame_size: int) -> list[tuple[int, int]]:
    """``reads`` turned to the first start whose frame differs from the
    frame the read before it ends in (unturned where none does)."""
    for k in range(len(reads)):
        off, _n = reads[k]
        prev_off, prev_n = reads[k - 1]
        if off // frame_size != (prev_off + prev_n - 1) // frame_size:
            return reads[k:] + reads[:k]
    return reads


class Loop(driver.Loop):
    def __init__(self, zt, cfg, mix, data, seed, device, rec):
        super().__init__(zt, cfg, mix, data, seed, device, rec)
        blob, st = zt.archive.compress_archive(
            data, frame_size=cfg["frame_size"], checksum=cfg["checksum"], level=cfg["level"],
            device=device)
        arc = blob + st.to_bytes(self.fmt)
        self.keep_archive(arc)
        self.dec = (zt.DecodeOptions(zt.BytesWrapper(arc)).with_backend("tpu")
                    .with_device(device).into_decoder())
        gen = importlib.import_module(f"portbench.data.{cfg['data']['generator']}")
        offs, lens = gen.layout(len(data))
        reads = [(int(offs[i]), int(lens[i])) for i in queries(mix, len(offs))]
        self.reads = turned(reads, cfg["frame_size"])

    def round(self) -> None:
        dec = self.dec
        for off, n in self.reads:
            with self.rec.span("decode", n) as c:
                dec.seek(off)
                got = dec.read(n)
                c.out_bytes = len(got)
            self.compare(got, off, off + n)
