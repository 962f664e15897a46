"""Device stages of the archive pipeline.

Six CUDA kernels (``csrc/``) carry the archive paths, each behind a
wrapper in its module that also holds the kernel's plain PyTorch version:

- ``match_kernel.match`` - level-1 LZ77 parse, one thread block per frame;
- ``reach_kernel.chunk_pointer_tables`` and ``reach_kernel.chunk_mark`` -
  the anchor pass of the parallel parse (levels 2-19, prefix mode, and
  level-1 frame sizes the match kernel does not take, ``match_tpu.py``);
- ``fse_kernel.fse_encode`` - FSE sequence bitstreams, one block per job;
- ``decode_kernel.wide_decode`` and ``ring_kernel.ring_decode`` - fused FSE
  decode and sequence execution, one block per frame.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``launches`` counts kernel
launches per wrapper (plain-version calls do not count).
"""

launches = {"match": 0, "reach_tables": 0, "reach_mark": 0, "fse": 0,
            "ring_decode": 0, "wide_decode": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
