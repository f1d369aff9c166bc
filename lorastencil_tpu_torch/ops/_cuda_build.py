"""Build the port's CUDA sources with nvcc and load them with ctypes.

Counterpart, in pattern only, of ``lorastencil_tpu/native/build.py``.
Each ``csrc/<name>.cu`` exposes a plain C interface; it is compiled at
first use into ``lorastencil_tpu_torch/build/`` as a shared library named
by a hash of its source, the ``csrc`` files it includes (``#include
"..."``) and the flags, so an edited source or flag builds anew and an
unchanged one is reused.  No PyTorch headers are included,
which keeps a build to seconds.

nvcc is looked up on PATH, then under ``torch.utils.cpp_extension``'s
CUDA_HOME.  A missing compiler or a failed build raises: nothing here
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
# Hopper only: sm_90a keeps wgmma/setmaxnreg available to later kernels.
# -Xptxas -v records registers, shared memory and spills in the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the port's CUDA "
        "kernels are built from source at first use and need the CUDA "
        "toolkit")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path.  The compiler's output is kept beside it
    as ``<library>.log``."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text)
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(CSRC, inc.decode()), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a stub
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; callers cache the
    handle and declare its functions' argument types."""
    return ctypes.CDLL(build(name))
