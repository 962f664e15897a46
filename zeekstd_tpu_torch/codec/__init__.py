"""Host Zstandard codec pieces the archive pipeline needs: bit streams,
FSE and Huffman tables, literal and sequence section headers, frame
headers, and the host frame encoder. Copies of the same modules of
``zeekstd_tpu.codec``."""

from .decompress import decompress_frame, DCtx
from .compress import compress_frame, CCtx

__all__ = ["decompress_frame", "DCtx", "compress_frame", "CCtx"]
