"""Histograms on the device: byte and code frequency counts feeding the
entropy table builders (Huffman weights, FSE normalized counts).

Port of ``zeekstd_tpu/ops/histogram.py`` (plain XLA there, plain torch
here). No archive path calls it in either package;
``byte_kernels.byte_histogram`` is the per-block histogram kernel, with
another signature."""

from __future__ import annotations

import torch


def byte_histogram(data, n_valid=None, nbins: int = 256):
    """Counts of each byte value in data[:n_valid]; data: uint8[N].
    Returns int32[nbins]."""
    idx = data.to(torch.int64)
    if n_valid is not None:
        weights = (torch.arange(idx.shape[0], device=idx.device) < n_valid).to(torch.int32)
    else:
        weights = torch.ones(idx.shape[0], dtype=torch.int32, device=idx.device)
    return torch.zeros(nbins, dtype=torch.int32, device=idx.device).index_add_(0, idx, weights)


def code_histograms(ll_codes, ml_codes, of_codes, n_valid):
    """Histograms of the three sequence-code streams, counting the first
    ``n_valid`` entries; codes are clamped into their alphabets (36, 53
    and 32 symbols). Returns (ll_h, ml_h, of_h) int32."""
    dev = ll_codes.device
    w = (torch.arange(ll_codes.shape[0], device=dev) < n_valid).to(torch.int32)

    def hist(codes, n):
        return torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, codes.to(torch.int64).clamp(0, n - 1), w)

    return hist(ll_codes, 36), hist(ml_codes, 53), hist(of_codes, 32)
