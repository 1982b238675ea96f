"""Build the port's native sources into shared libraries and load them.

Each ``lisec_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``lisec_tpu_torch/_build/lib<name>-<hash>.so``, then loaded with
``ctypes``. A ``csrc/<name>.cc`` is host code, compiled the same way by
``g++`` for any x86-64 or aarch64 host (no ``-march``), without
``-ffast-math`` and without floating-point contraction, so that its f32
arithmetic is IEEE's, operation for operation. A source may add flags of
its own (``SOURCE_FLAGS``) and include headers beside it
(``#include "x.cuh"``). The hash covers the source, the headers it
includes and the flags, so an edited source or header is rebuilt and a
built one is reused. Nothing is compiled when a module is imported: a
wrapper builds its library at its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC")
# Flags of single sources, after the route's own. The NMS kernel's IoU
# rounds every product and sum as torch's elementwise ops do.
SOURCE_FLAGS = {"rotated_nms": ("-fmad=false", "-prec-div=true")}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels of lisec_tpu_torch are built from source")
    return path


def gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH; the host code of lisec_tpu_torch is "
            "built from source")
    return path


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` (device code), else ``csrc/<name>.cc`` (host
    code)."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _compiler(src: Path):
    """(compiler, flags) for a source, chosen by its suffix, and the
    source's own flags."""
    extra = SOURCE_FLAGS.get(src.stem, ())
    if src.suffix == ".cu":
        return nvcc_path, NVCC_FLAGS + extra
    return gxx_path, HOST_FLAGS + extra


def library_path(name: str) -> Path:
    src = source_path(name)
    flags = _compiler(src)[1]
    text = src.read_bytes()
    headers = b"".join((src.parent / inc.decode()).read_bytes()
                       for inc in _INCLUDE.findall(text)
                       if (src.parent / inc.decode()).exists())
    digest = hashlib.sha256(text + headers + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` (or ``.cc``) unless it is built
    already.

    Returns ``{"seconds": s, "log": compiler output}`` (0 and "" when the
    library was already built). Raises if the compiler fails. Each call
    compiles to a temporary file of its own and renames it into place, so
    ranks that build at once cannot interleave their writes.
    """
    out = library_path(name)
    if out.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{out.name}.{os.getpid()}.",
                               suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        src = source_path(name)
        compiler, flags = _compiler(src)
        cmd = [compiler(), *flags, "-o", tmp, str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {src.name}:\n{log}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"seconds": seconds, "log": log}


# ``torch._C._cuda_getCurrentRawStream`` gives the raw handle without the
# Python ``Stream`` object that ``torch.cuda.current_stream`` builds, a
# few microseconds a call; the public call stands in where it is missing.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s card, for a
    launch."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def bind(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The entry point ``entry`` of ``csrc/<name>.cu`` (built and loaded
    on first use) with its argument types set, returning the C ``int``
    error code. A wrapper binds it once and keeps it."""
    fn = getattr(load(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
