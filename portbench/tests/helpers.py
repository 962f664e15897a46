"""Shared pieces of the benchmark's tests: the manifest, a cell cut to a
size the CPU runs in seconds, and faults planted in the program."""

from __future__ import annotations

import contextlib

from portbench import manifest, run

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY_FRAME, TINY_BYTES = 65536, 150000


def cell_parts(name: str, tiny: bool = True):
    cell = manifest.cell(BENCH, name)
    cfg = manifest.config(BENCH, cell["config"])
    if tiny:
        cfg = dict(cfg, frame_size=TINY_FRAME, data=dict(cfg["data"], bytes=TINY_BYTES))
    return cell, cfg, manifest.mix(cell["traffic"])


def execute(name: str, seed: int = 5, seconds: float = 0.5, trace: bool = False,
            tiny: bool = True, device="cpu", **mix_params):
    import zeekstd_tpu_torch as zt
    import zeekstd_tpu_torch.ops  # noqa: F401

    cell, cfg, mix = cell_parts(name, tiny)
    mix = dict(mix, **mix_params)
    return run.execute(BENCH, cell, cfg, mix, zt, seed, seconds, trace, device=device)


@contextlib.contextmanager
def planted(monkeypatch, fault: str):
    """Break the program under the harness: ``control_frames`` (a frame every
    two configured frames), ``control_checksum`` (no content checksums),
    ``flip_encode`` / ``flip_decode`` / ``flip_frame`` (one byte altered
    where it is produced), ``half_encode`` / ``half_decode`` (half of the
    frames left out), ``zeros_decode`` (the output returned as allocated,
    never written), ``stale_frame`` (the Decoder's frame cache never moves)."""
    import zeekstd_tpu_torch as zt

    arch = zt.archive
    compress, decompress, frame = arch.compress_archive, arch.decompress_archive, arch.decompress_frame

    def flip(b: bytes) -> bytes:
        b = bytearray(b)
        b[len(b) // 2] ^= 0x20
        return bytes(b)

    if fault == "control_frames":
        monkeypatch.setattr(arch, "compress_archive",
                            lambda d, frame_size, *a, **k: compress(d, 2 * frame_size, *a, **k))
    elif fault == "control_checksum":
        monkeypatch.setattr(arch, "compress_archive",
                            lambda d, *a, **k: compress(d, *a, **dict(k, checksum=False)))
    elif fault == "flip_encode":
        def flipped(*a, **k):
            blob, st = compress(*a, **k)
            return flip(blob), st
        monkeypatch.setattr(arch, "compress_archive", flipped)
    elif fault == "half_encode":
        def half(d, frame_size, *a, **k):
            keep = max(1, -(-len(d) // frame_size) // 2) * frame_size
            return compress(bytes(d[:keep]), frame_size, *a, **k)
        monkeypatch.setattr(arch, "compress_archive", half)
    elif fault == "flip_decode":
        monkeypatch.setattr(arch, "decompress_archive", lambda *a, **k: flip(decompress(*a, **k)))
    elif fault == "half_decode":
        def half_out(*a, **k):
            out = decompress(*a, **k)
            return out[: len(out) // 2]
        monkeypatch.setattr(arch, "decompress_archive", half_out)
    elif fault == "zeros_decode":
        monkeypatch.setattr(arch, "decompress_archive",
                            lambda *a, **k: bytes(len(decompress(*a, **k))))
    elif fault == "flip_frame":
        def flipped_frame(*a, **k):
            out, end = frame(*a, **k)
            return flip(out), end
        monkeypatch.setattr(arch, "decompress_frame", flipped_frame)
    elif fault == "stale_frame":
        load = zt.decode.Decoder._load_frame

        def stale(self, index):
            if getattr(self, "_stale_data", None) is None:
                load(self, index)
                self._stale_data = self._cur_data
            self._cur_frame, self._cur_data = index, self._stale_data
        monkeypatch.setattr(zt.decode.Decoder, "_load_frame", stale)
    else:
        raise ValueError(fault)
    yield
