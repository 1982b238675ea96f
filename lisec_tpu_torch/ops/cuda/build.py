"""Build the port's CUDA sources into shared libraries and load them.

Each ``lisec_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``lisec_tpu_torch/_build/lib<name>-<hash>.so``, then loaded with
``ctypes``. The hash covers the source and the flags, so an edited
source is rebuilt and a built one is reused. Nothing is compiled when a
module is imported: a wrapper builds its library at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` unless it is built already.

    Returns ``{"seconds": s, "log": nvcc output}`` (0 and "" when the
    library was already built). Raises if nvcc fails.
    """
    out = library_path(name)
    if out.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return {"seconds": seconds, "log": log}


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s card, for a
    launch. ``torch._C._cuda_getCurrentRawStream`` skips the Python
    ``Stream`` object that ``torch.cuda.current_stream`` builds, a few
    microseconds a call; the public call stands in where it is missing."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
