"""Host Zstandard codec pieces the archive pipeline needs: bit streams,
FSE and Huffman tables, literal and sequence section headers, frame
headers, and the host frame encoder. Copies of the same modules of
``zeekstd_tpu.codec``."""
