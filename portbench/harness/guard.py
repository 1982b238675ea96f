"""The run's environment: caches inside the checkout, and the check that
nothing of JAX or of the JAX package was loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

# Top-level module names that no process of the benchmark may hold:
# compared whole, so the port (``lisec_tpu_torch``) is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "lisec_tpu")


# Host threads of the one process that offers the load: few, so that a
# run does not contend with itself, or with others on a shared host.
HOST_THREADS = "2"


def set_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout (the port builds its
    CUDA sources into ``lisec_tpu_torch/_build`` by itself), libraries
    kept from loading JAX on their own, and few host threads. Call it
    before torch or numpy is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    cache = root / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)
