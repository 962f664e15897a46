"""zeekstd_tpu_torch - the PyTorch/CUDA port of zeekstd_tpu's archive path.

Seekable-Zstandard archive encode at levels 1-19 (with patch-mode
prefixes) and archive and frame decode on an NVIDIA H100 (the fused
route by default, the serial and pointer-doubling routes under
``ZEEKSTD_TPU_EXEC``), through hand-written CUDA kernels (``csrc/``):
the level-1 LZ77 match finder, the two chunked-reachability kernels, the
FSE sequence encoder and decoder, the two fused decoders, the serial
sequence executor, and the byte histogram and table lookup. Archives are
byte-identical to ``zeekstd_tpu.tpu_archive.tpu_compress_archive``; this
package imports neither JAX nor ``zeekstd_tpu``.

Entry points run on the CUDA card unless called with ``device="cpu"``,
which runs each kernel's plain PyTorch version.
"""

from .archive import (
    StagedInput,
    compress_archive,
    decode_frames,
    decompress_archive,
    decompress_frame,
)
from .device import (from_reference_arrays, phase_records, phase_timer, resolve_device,
                     set_timing)
from .errors import ZeekstdError, ZstdError
from .seek_table import Format, SeekTable

__all__ = [
    "StagedInput",
    "compress_archive",
    "decode_frames",
    "decompress_archive",
    "decompress_frame",
    "from_reference_arrays",
    "phase_records",
    "phase_timer",
    "resolve_device",
    "set_timing",
    "ZeekstdError",
    "ZstdError",
    "Format",
    "SeekTable",
]
