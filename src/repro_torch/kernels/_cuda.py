"""Builds and loads the port's CUDA C++ kernels (``csrc/*.cu``).

Each source has a plain ``extern "C"`` entry point and includes none of
PyTorch's headers. At first use it is compiled by ``nvcc`` for ``sm_90a``
into a shared library under ``build/cuda/`` of the checkout, named by a
hash of its source, the shared headers and the flags (so a stale library
is never loaded, and editing one kernel rebuilds no other),
and loaded with ``ctypes``; the caller passes ``data_ptr()``s and the
current stream as ``c_void_p``. ``nvcc`` is looked up on ``PATH``, then
under PyTorch's ``CUDA_HOME``; without it the build raises. No fast-math:
``expf`` and ``tanhf`` stay close to the plain versions'. ptxas's
register, shared-memory and spill report is kept beside the library
(:func:`build_log`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(ROOT, "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc is neither on PATH nor under CUDA_HOME: the "
                       "port's CUDA kernels are built from source at first "
                       "use")


def _library_path(name: str) -> str:
    """The library's path, named by a hash of the flags, of
    ``csrc/<name>.cu`` and of the shared headers (``csrc/*.cuh``), so that
    editing one kernel's source rebuilds that kernel alone."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                   if f.endswith(".cuh"))
    for f in srcs:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiling it first when
    no library of the current sources exists."""
    so = _library_path(name)
    if not os.path.exists(so):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc could not build {name}.cu:\n"
                               f"{proc.stderr[-6000:]}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def build_log(name: str) -> str:
    """nvcc's and ptxas's output from building the current library of
    ``csrc/<name>.cu`` ("" when it was not built from this checkout)."""
    path = _library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
