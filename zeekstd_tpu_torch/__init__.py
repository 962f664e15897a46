"""zeekstd_tpu_torch - the PyTorch/CUDA port of zeekstd_tpu.

Seekable-Zstandard archive encode at levels 1-19 (with patch-mode
prefixes) and archive and frame decode on an NVIDIA H100 (the fused
route by default, the serial and pointer-doubling routes under
``ZEEKSTD_TPU_EXEC``), through hand-written CUDA kernels (``csrc/``):
the level-1 LZ77 match finder, the two chunked-reachability kernels, the
FSE sequence encoder and decoder, the two fused decoders, the serial
sequence executor, and the byte histogram and table lookup. Archives are
byte-identical to ``zeekstd_tpu.tpu_archive.tpu_compress_archive``; this
package imports neither JAX nor ``zeekstd_tpu``.

The streaming ``Encoder``/``Decoder`` (``encode``, ``decode``) and the
``zeekstd`` command line (``python -m zeekstd_tpu_torch``) reach the card
through their ``tpu`` backend; ``native`` (the default, ``auto``, when
it builds) runs the host C++ runtime (``native/``) and ``python`` the
host codec. ``frame_codec.compress_frame`` is the per-frame device
encoder. ``zeekstd_tpu_torch.parallel`` (not imported here, as in the
reference) runs the archive paths over a mesh of devices and processes
on ``torch.distributed``.

Entry points run on the CUDA card unless called with ``device="cpu"``
(``with_device("cpu")``, ``--device cpu``), which runs each kernel's
plain PyTorch version. ``compress_frame`` and ``decompress_frame`` are
the host codec's (``codec``), as in the reference; the device decoder of
one frame is ``archive.decompress_frame``.

``ZEEKSTD_TPU_BLOCK`` (read once, at import, by ``archive``) sets the
archive encoder's block size, 32 KiB by default and at most 128 KiB.
"""

from .archive import StagedInput, compress_archive, decode_frames, decompress_archive
from .codec import CCtx, DCtx, compress_frame, decompress_frame
from .decode import DecodeOptions, Decoder
from .device import (from_reference_arrays, phase_records, phase_timer, resolve_device,
                     set_timing)
from .encode import (
    CompressionProgress,
    EncodeOptions,
    Encoder,
    EpilogueProgress,
    FrameSizePolicy,
    RawEncoder,
)
from .errors import (
    FrameIndexTooLargeError,
    NumberConversionError,
    OffsetOutOfRangeError,
    ZeekstdError,
    ZstdError,
)
from .seek_table import Format, Parser, SeekTable, Serializer
from .seekable import BytesWrapper, End, FileWrapper, Seekable, Start

__version__ = "0.1.0"

__all__ = [
    "StagedInput",
    "compress_archive",
    "decode_frames",
    "decompress_archive",
    "from_reference_arrays",
    "phase_records",
    "phase_timer",
    "resolve_device",
    "set_timing",
    "CCtx",
    "DCtx",
    "compress_frame",
    "decompress_frame",
    "DecodeOptions",
    "Decoder",
    "CompressionProgress",
    "EpilogueProgress",
    "EncodeOptions",
    "Encoder",
    "FrameSizePolicy",
    "RawEncoder",
    "Format",
    "Parser",
    "SeekTable",
    "Serializer",
    "BytesWrapper",
    "End",
    "FileWrapper",
    "Seekable",
    "Start",
    "ZeekstdError",
    "ZstdError",
    "OffsetOutOfRangeError",
    "FrameIndexTooLargeError",
    "NumberConversionError",
]
