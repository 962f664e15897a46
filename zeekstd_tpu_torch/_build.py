"""Build the port's shared libraries from the sources in this package.

Two libraries, both with a plain C interface loaded through ``ctypes``:

- ``native/zeekstd_native.cpp`` -> the native runtime (g++, with the JAX
  package's flags, ``-march=native`` among them): the host frame codec,
  the threaded stream helpers, XXH64, and the Huffman table construction
  and stream decoding of the archive pipeline.
- ``csrc/*.cu`` -> the kernel library (nvcc, ``sm_90a``): the CUDA
  kernels of the archive pipeline. It is built only when a wrapper is
  about to launch a kernel, so importing the package needs no ``nvcc``.

Each library is built once into ``build/`` beside the package (listed in
``.gitignore``) under a name keyed by the hash of its sources and flags
(and, for ``-march=native``, of the host CPU's model and features, so a
build directory copied to another machine is never loaded there), and
moved into place with an atomic rename, so concurrent processes never
load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "zeekstd_tpu_torch")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def cuda_sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _host_cpu() -> bytes:
    """The CPU's model names and feature flags, as /proc/cpuinfo lists them."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return platform.machine().encode()
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def _digest(sources, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    if "-march=native" in cmd:
        h.update(_host_cpu())
    for s in sources:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def load(name: str, compiler: list[str], sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` with ``compiler`` into
    ``build/lib<name>-<hash>.so`` unless it exists, and load it once per
    process. Raises on a failed build."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            so = os.path.join(BUILD_DIR, f"lib{name}-{_digest(sources, compiler)}.so")
            if not os.path.exists(so):
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = compiler + ["-o", tmp] + sources
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"building {name} failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}"
                    )
                os.replace(tmp, so)
            lib = _libs[name] = ctypes.CDLL(so)
        return lib


def nvcc() -> str:
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def kernel_library() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use: one ``nvcc -c`` per
    ``csrc/*.cu``, all started together, then one link. The compiler's
    ``-Xptxas -v`` report is kept beside the library (``ptxas_report``)."""
    with _lock:
        lib = _libs.get("kernels")
        if lib is None:
            lib = ctypes.CDLL(_build_kernels())
            _libs["kernels"] = lib
        return lib


def _kernel_paths():
    srcs = cuda_sources()
    so = os.path.join(
        BUILD_DIR, f"libzeekstd_torch_kernels-{_digest(srcs, NVCC_FLAGS)}.so"
    )
    return srcs, so, so + ".ptxas.txt"


def _build_kernels() -> str:
    srcs, so, report = _kernel_paths()
    if os.path.exists(so) and os.path.exists(report):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc()] + compile_flags + ["-Xptxas", "-v", "-c", "-o", obj, src]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    lines, objs = [], []
    for src, obj, cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}{err}")
        lines.append(f"{os.path.basename(src)}:\n{err.strip()}")
        objs.append(obj)
    cmd = [nvcc()] + NVCC_FLAGS + ["-o", so + f".{tag}"] + objs
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stderr}")
    with open(report + f".{tag}", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.replace(report + f".{tag}", report)
    os.replace(so + f".{tag}", so)
    return so


def ptxas_report() -> str:
    """Registers, shared memory and spills of every kernel, as
    ``nvcc -Xptxas -v`` printed them when the library was built."""
    kernel_library()
    with open(_kernel_paths()[2]) as fh:
        return fh.read()
