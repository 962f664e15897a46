"""Data-parallel seekable compression over a mesh of devices and processes
(``torch.distributed``: NCCL on the card, gloo on the CPU).

The reference is single-threaded (SURVEY §2.4); the seekable format's
frame independence is exactly what makes this layer possible: input
chunks shard per device, each device parses/encodes its frames locally,
and per-frame sizes (the seek-table entries) are all-gathered in frame
order so every process can build the identical seek table - collectives
instead of the reference's sequential writer.
"""

from .multihost import (
    host_write_plan,
    init_multihost,
    make_multihost_mesh,
    multihost_compress,
    process_frame_slice,
)
from .pipeline import (
    make_mesh,
    parallel_compress,
    parallel_decompress,
    parallel_parse_step,
    parallel_random_access,
    route_queries,
)

__all__ = [
    "host_write_plan",
    "init_multihost",
    "make_mesh",
    "make_multihost_mesh",
    "multihost_compress",
    "parallel_compress",
    "parallel_decompress",
    "parallel_parse_step",
    "parallel_random_access",
    "process_frame_slice",
    "route_queries",
]
