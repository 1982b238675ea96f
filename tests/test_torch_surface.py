"""The port's public surface against the JAX package's.

For every module of ``lisec_tpu`` each public top-level function or
class defined there, and each name of its ``__all__``, has a counterpart
of the same name at the same module path under ``lisec_tpu_torch``. The
exceptions: the Pallas kernels' modules, whose counterparts are the CUDA
wrappers under ``lisec_tpu_torch/ops/cuda/``, and the names in
``JAX_ONLY``, each with the reason it has none. A second test keeps that
list honest: every name in it still exists in the JAX package.
"""

from __future__ import annotations

import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# The module list comes from the source files, so every worker collects
# the same tests whatever it has imported or built.
JAX_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts[:-1]
             if p.name == "__init__.py"
             else p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "lisec_tpu").rglob("*.py"))

# The Pallas kernels' modules and their CUDA counterparts.
KERNEL_MODULES = {
    "lisec_tpu.ops.pallas": "lisec_tpu_torch.ops.cuda.fps",
    "lisec_tpu.ops.pallas.encoder_kernel":
        "lisec_tpu_torch.ops.cuda.encoder_kernel",
    "lisec_tpu.ops.pallas.fps_kernel": "lisec_tpu_torch.ops.cuda.fps",
    "lisec_tpu.ops.pallas.gather_mxu": "lisec_tpu_torch.ops.cuda.gather_rows",
    "lisec_tpu.ops.pallas.pillar_paint":
        "lisec_tpu_torch.ops.cuda.segment_paint",
    "lisec_tpu.ops.pallas.spread_kernel":
        "lisec_tpu_torch.ops.cuda.spread_accumulate",
    "lisec_tpu.ops.pallas.unpaint": "lisec_tpu_torch.ops.cuda.segment_unpaint",
}

# Kernel entry points named for the TPU unit they used.
RENAMED = {
    "lisec_tpu.ops.pallas:fps_pallas": "fps",
    "lisec_tpu.ops.pallas.fps_kernel:fps_pallas": "fps",
    "lisec_tpu.ops.pallas.gather_mxu:gather_rows_mxu": "gather_rows",
    "lisec_tpu.ops.pallas.gather_mxu:scatter_rows_mxu": "scatter_rows",
}

_LANES = ("a TPU lane layout (columns of 128 lanes); the port computes in "
          "the row layout")
_SPANS = ("a fenced wall-clock timer of stages; the port's spans "
          "(utils.profiling.span) time its stages on the host and on the "
          "card's stream under a profiler")
_PORTBENCH = "measured by `portbench/`"
JAX_ONLY = {
    "lisec_tpu.bench_lib:chain_time":
        "a lax.scan loop that times a chain of calls on the device; the "
        "port times with CUDA events (bench_lib.event_seconds)",
    "lisec_tpu.bench_lib:bench_inference": _PORTBENCH,
    "lisec_tpu.bench_lib:bench_second": _PORTBENCH,
    "lisec_tpu.bench_lib:bench_voxelize": _PORTBENCH,
    "lisec_tpu.bench_lib:measure_sync_floor": _PORTBENCH,
    "lisec_tpu.bench_lib:run_benchmark": _PORTBENCH,
    "lisec_tpu.pipelines:TrainState":
        "a flax train state; the port's pipeline holds its model and "
        "optimizer (Pipeline.state_dict())",
    "lisec_tpu.pipelines.base:TrainState":
        "a flax train state; the port's pipeline holds its model and "
        "optimizer (Pipeline.state_dict())",
    "lisec_tpu.parallel:batch_sharding":
        "a jax.sharding object; the port uses parallel.shard_batch and "
        "use_mesh",
    "lisec_tpu.parallel:replicated_sharding":
        "a jax.sharding object; the port uses parallel.shard_batch and "
        "use_mesh",
    "lisec_tpu.parallel.mesh:batch_sharding":
        "a jax.sharding object; the port uses shard_batch and use_mesh",
    "lisec_tpu.parallel.mesh:replicated_sharding":
        "a jax.sharding object; the port uses shard_batch and use_mesh",
    "lisec_tpu.ops.boxes:encode_boxes_cols": _LANES,
    "lisec_tpu.training.losses:sin_difference_cols": _LANES,
    "lisec_tpu.training.assigner:_gt_columns": _LANES,
    "lisec_tpu.training.assigner:_window_anchor_columns": _LANES,
    "lisec_tpu.ops.knn_refine:_shifted_stack_cols": _LANES,
    "lisec_tpu.ops.knn_refine:_build_table_cols": _LANES,
    "lisec_tpu.models.second:MaskedBatchNorm":
        "the masked batch norm of the dense tail lives inside the port's "
        "DenseConv3D",
    "lisec_tpu.native:_build":
        "builds the C++ library; the port's native helpers are numpy",
    "lisec_tpu.native:_load":
        "loads the C++ library; the port's native helpers are numpy",
    "lisec_tpu.ops.pallas.gather_mxu:fits_vmem":
        "the TPU's VMEM capacity test; the CUDA gather takes any table",
    "lisec_tpu.utils:Timer": _SPANS,
    "lisec_tpu.utils:device_sync": _SPANS,
    "lisec_tpu.utils.profiling:Timer": _SPANS,
    "lisec_tpu.utils.profiling:device_sync": _SPANS,
}


def _public_names(mod) -> set:
    names = set(getattr(mod, "__all__", ()) or ())
    for name, obj in vars(mod).items():
        if (not name.startswith("_") and callable(obj)
                and not inspect.ismodule(obj)
                and getattr(obj, "__module__", None) == mod.__name__):
            names.add(name)
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(module):
    jax_mod = importlib.import_module(module)
    port_name = KERNEL_MODULES.get(
        module, "lisec_tpu_torch" + module[len("lisec_tpu"):])
    port = importlib.import_module(port_name)
    missing = []
    for name in sorted(_public_names(jax_mod)):
        key = f"{module}:{name}"
        if key in JAX_ONLY:
            continue
        if not hasattr(port, RENAMED.get(key, name)):
            missing.append(name)
    assert not missing, f"{port_name} lacks {missing}"


@pytest.mark.parametrize("key", sorted({**JAX_ONLY, **RENAMED}))
def test_every_listed_exception_still_exists_in_the_jax_package(key):
    module, name = key.split(":")
    assert hasattr(importlib.import_module(module), name), key
    if key in JAX_ONLY:
        assert JAX_ONLY[key].strip()


def test_the_kernel_module_map_covers_the_pallas_package():
    pallas = {m for m in JAX_MODULES if m.startswith("lisec_tpu.ops.pallas")}
    assert pallas == set(KERNEL_MODULES)
    for port in set(KERNEL_MODULES.values()):
        importlib.import_module(port)


def test_version_and_config_helpers_at_the_top_level():
    import lisec_tpu
    import lisec_tpu_torch
    assert lisec_tpu_torch.__version__ == lisec_tpu.__version__
    assert set(lisec_tpu.__all__) <= set(lisec_tpu_torch.__all__)
    cfg = lisec_tpu_torch.load_config(str(ROOT / "configs/second_tiny.yaml"))
    d = lisec_tpu_torch.config_to_dict(cfg)
    assert d == lisec_tpu.config_to_dict(
        lisec_tpu.load_config(str(ROOT / "configs/second_tiny.yaml")))
    assert lisec_tpu_torch.config_from_dict(d) == cfg
