"""Builds the port's hand-written CUDA sources (``vectorsearch_torch/csrc/*.cu``)
into shared libraries with a plain C interface and loads them with ctypes.

Every source builds the same way, at first use and on the machine with the
card: ``nvcc`` for ``sm_90a`` into ``vectorsearch_torch/_build/lib<name>_<hash>.so``.
The library name carries a hash of the source, so a stale build is never
loaded; the build writes a temporary file and renames it, so concurrent
builds never load a half-written library. Nothing here runs when a module
is imported: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found: the port's kernels build from {CSRC_DIR} with the "
        "CUDA toolkit"
    )


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compiles csrc/<name>.cu for sm_90a into _build/ (if that source's
    library is not there yet) and returns (library path, compiler output;
    empty when the library was already built). ``defines``: preprocessor
    macros of a measurement variant (``-D``), which builds a library of its
    own."""
    src = source_path(name)
    with open(src, "rb") as f:
        text = f.read()
    if defines:
        text += repr(sorted(defines)).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}.{threading.get_ident()}.so"
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        *(f"-D{m}" for m in defines), "-o", tmp, src,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path, proc.stdout + proc.stderr


def load(name: str, bind: Callable[[ctypes.CDLL], None],
         defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built with ``defines``), built
    on first use; ``bind`` sets the C entry points' argument and result
    types once."""
    key = name if not defines else f"{name}{sorted(defines)}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path, _ = build(name, defines)
            lib = ctypes.CDLL(path)
            bind(lib)
            _libs[key] = lib
        return lib
