"""Shared plumbing of the kernel wrappers: argument checks, raw pointers,
the current CUDA stream, and the launchers' error codes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong

# Device bytes a launch's allocations may take beyond their sizes: the
# caching allocator rounds each up to 512 B, and hands a large one up to
# 1 MiB more when it would leave less than that of a cached segment.
ALLOC_SLACK = 16 << 20


def padded_records(n: int) -> int:
    """Rows of a record table of n records: a power of two, at least 8."""
    return 1 << max((n - 1).bit_length(), 3)


def kernel_fn(name: str, argtypes):
    """The launcher ``name`` of the kernel library (built on first use);
    every launcher returns ``cudaGetLastError()`` as an int."""
    lib = _build.kernel_library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check_cuda(name: str, t: torch.Tensor, dtype=torch.int32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        msg = _build.kernel_library().zk_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{kernel} kernel launch failed: {msg(rc).decode()} ({rc})")
