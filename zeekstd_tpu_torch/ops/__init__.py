"""Device stages of the archive pipeline.

Ten CUDA kernels (``csrc/``), each behind a wrapper in its module that
also holds the kernel's plain PyTorch version:

- ``match_kernel.match`` - level-1 LZ77 parse, one thread block per frame;
- ``reach_kernel.chunk_pointer_tables`` and ``reach_kernel.chunk_mark`` -
  the anchor pass of the parallel parse (levels 2-19, prefix mode,
  level-1 frame sizes the match kernel does not take and level 1 under
  ``ZEEKSTD_TPU_MATCH=xla``, ``match_tpu.py``) and of the device Huffman
  decode (``huffman_spec.py``);
- ``fse_kernel.fse_encode`` - FSE sequence bitstreams, one block per job;
- ``decode_kernel.wide_decode`` - fused FSE decode and sequence execution
  for any window, in three stages: FSE decode per block, a scan per frame
  that writes one descriptor per output byte, pointer jumping over the
  descriptors;
- ``ring_kernel.ring_decode`` - the same for windows of at most 512 KiB,
  on the ring contract's instances of those stages;
- ``entropy.fse_decode_sequences`` - FSE sequence decode, one warp per
  block over its tables and bitstream staged in shared memory, the
  states walked 64 sequences at a time and those sequences decoded
  across the lanes, two per lane (the serial and pointer-doubling decode
  routes);
- ``exec_kernel.serial_exec`` - execution of pre-decoded sequences (the
  serial decode route), on the exec contract's instances of the wide
  decoder's scan and pointer jumping;
- ``byte_kernels.byte_histogram`` and ``byte_kernels.table_lookup`` -
  tile-local byte passes, on no archive path (as in the reference).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``launches`` counts kernel
launches per wrapper (plain-version calls do not count).
"""

launches = {"match": 0, "reach_tables": 0, "reach_mark": 0, "fse": 0,
            "ring_decode": 0, "wide_decode": 0, "fse_decode": 0, "exec": 0,
            "byte_histogram": 0, "table_lookup": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
