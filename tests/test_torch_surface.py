"""PyTorch port: the top-level frame pair against the JAX package's.

``zeekstd_tpu.compress_frame`` and ``zeekstd_tpu.decompress_frame`` are
the host codec's (``zeekstd_tpu/codec``); the port exports the same pair
from its own codec copy, at the top level and in ``codec``, so the same
calls give the same frames, the same decoded bytes and end positions, a
skippable frame's ``(b"", end)``, and the same error on a broken frame.
The device decoder of one frame stays ``archive.decompress_frame``.
"""

import pytest

pytest.importorskip("jax")

import zeekstd_tpu as ref  # noqa: E402
import zeekstd_tpu_torch as zt  # noqa: E402
from zeekstd_tpu_torch import archive, codec  # noqa: E402

from .block_cases import long_run, word_text  # noqa: E402
from .torch_threads import two_torch_threads  # noqa: F401

PAIR = ("CCtx", "DCtx", "compress_frame", "decompress_frame")
DATA = {"empty": b"", "short": b"hello, frame", "text": word_text(40_000),
        "long_run": long_run(200_000)}
CALLS = {"L1": dict(level=1), "L3 checksum": dict(level=3, checksum=True),
         "L9": dict(level=9), "prefix": dict(level=3, prefix=word_text(8_000, seed=3))}
SKIPPABLE = (0x184D2A5E).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"


@pytest.mark.parametrize("name", PAIR)
def test_top_level_names_are_the_codec_pair(name):
    assert name in ref.__all__ and name in zt.__all__ and name in codec.__all__
    assert getattr(zt, name) is getattr(codec, name)
    assert getattr(zt, name).__module__.split(".")[-1] == \
        getattr(ref, name).__module__.split(".")[-1]


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("name", list(DATA))
def test_frame_pair_equals_reference(name, call):
    data, kw = DATA[name], CALLS[call]
    frame = zt.compress_frame(data, **kw)
    assert frame == ref.compress_frame(data, **kw)
    pre = kw.get("prefix", b"")
    tail = SKIPPABLE + b"trailing"
    got = zt.decompress_frame(frame + tail, 0, prefix=pre)
    assert got == ref.decompress_frame(frame + tail, 0, prefix=pre) == (data, len(frame))


def test_skippable_frame_decodes_to_nothing():
    blob = b"x" + SKIPPABLE
    assert zt.decompress_frame(blob, 1) == ref.decompress_frame(blob, 1) == (b"", 12)
    with pytest.raises(zt.ZeekstdError):
        archive.decompress_frame(blob, 1, device="cpu")


def test_broken_frame_fails_alike():
    frame = bytearray(zt.compress_frame(DATA["text"], level=3, checksum=True))
    frame[-1] ^= 0x40  # the checksum
    with pytest.raises(zt.ZeekstdError) as got:
        zt.decompress_frame(bytes(frame))
    with pytest.raises(ref.ZeekstdError) as want:
        ref.decompress_frame(bytes(frame))
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
