"""Tile-local byte kernels: per-block byte histograms and a 256-entry
table lookup over bytes, with their plain versions and CUDA wrappers.

Port of ``byte_histogram_pallas`` and ``table_lookup_pallas`` of
``zeekstd_tpu/ops/pallas_kernels.py``. As in the reference, no archive
path calls them: the histogram is the statistics pass of a batched
encoder, the lookup the per-symbol (code, bit count) map of a Huffman
encoder. Both wrappers run their plain version for CPU tensors and launch
their CUDA kernel (``csrc/byte_kernels.cu``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import launches
from ._launch import I, L, P, check_cuda, check_rc, kernel_fn, ptr, stream


def histogram_plain(data: torch.Tensor, block: int = 1 << 15) -> torch.Tensor:
    """uint8[n] -> int32[n // block, 256]: a scatter-add of ones into each
    block's 256 bins."""
    n = data.shape[0]
    nblk = n // block
    bins = (torch.arange(n, device=data.device) // block) * 256 + data.to(torch.int64)
    out = torch.zeros(nblk * 256, dtype=torch.int32, device=data.device)
    out.scatter_add_(0, bins, torch.ones(n, dtype=torch.int32, device=data.device))
    return out.reshape(nblk, 256)


def lookup_plain(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """uint8[n], a 256-entry integer table -> int32[n]: ``table[data[i]]``."""
    return table.to(torch.int32)[data.to(torch.int64)]


def byte_histogram(data: torch.Tensor, block: int = 1 << 15) -> torch.Tensor:
    """Per-block byte histograms: uint8[n] -> int32[n // block, 256]
    (``n % block == 0``, ``block % 128 == 0``)."""
    n = data.shape[0]
    if block <= 0 or n % block != 0 or block % 128 != 0:
        raise ValueError(
            f"byte_histogram needs n % block == 0 and block % 128 == 0 (n={n}, block={block})"
        )
    if data.device.type == "cpu":
        return histogram_plain(data, block)
    check_cuda("data", data, torch.uint8)
    nblk = n // block
    out = torch.empty((nblk, 256), dtype=torch.int32, device=data.device)
    fn = kernel_fn("zk_byte_histogram_launch", [P, L, I, P, P])
    rc = fn(ptr(data), n, block, ptr(out), stream())
    launches["byte_histogram"] += 1
    check_rc("byte_histogram", rc)
    return out


def table_lookup(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[data[i]]``: uint8[n], a 256-entry table of any
    integer dtype (cast to int32, as the reference casts it) -> int32[n]
    (``n % 1024 == 0``)."""
    n = data.shape[0]
    if n % 1024 != 0:
        raise ValueError("table_lookup needs n % 1024 == 0 (pad the data)")
    if table.numel() != 256:
        raise ValueError("table_lookup needs a 256-entry table")
    if data.device.type == "cpu":
        return lookup_plain(data, table)
    check_cuda("data", data, torch.uint8)
    if not table.is_cuda:
        raise ValueError("table must be a CUDA tensor")
    tab = table.to(device=data.device, dtype=torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    fn = kernel_fn("zk_table_lookup_launch", [P, L, P, P, P])
    rc = fn(ptr(data), n, ptr(tab), ptr(out), stream())
    launches["table_lookup"] += 1
    check_rc("table_lookup", rc)
    return out
