"""Build the port's CUDA sources into plain C-ABI shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout
(a directory git ignores) the first time a wrapper needs it, and loaded
with ``ctypes``. The hash covers the source and the flags, so an edited
source is rebuilt. A missing ``nvcc`` or a failed build raises; nothing
falls back. The compiler's report (``-Xptxas -v``: registers, shared
memory, spills) is kept beside the library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    cand = None if CUDA_HOME is None else os.path.join(CUDA_HOME, "bin",
                                                       "nvcc")
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use and need the CUDA toolkit (put nvcc on PATH or set "
        "CUDA_HOME)")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            todo[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, todo[name])     # atomic for racing builds
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """Load the built library for ``csrc/<name>.cu``, building it if
    needed."""
    return ctypes.CDLL(str(build(name)[name]))
