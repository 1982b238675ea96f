"""The port's ``bench_lib`` (weight files, the fixture batch),
``utils/profiling`` and ``ops`` exports, on the CPU.

Weight files: a snapshot the JAX package writes loads into the port bit
for bit, and one the port writes loads into the JAX package bit for bit,
for every model of the port.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu import bench_lib as jax_bench_lib
from lisec_tpu import ops as jax_ops
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu_torch import bench_lib, ops
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.utils import clear_spans, span, spans, trace
from lisec_tpu_torch.weights import to_flax_arrays

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(ROOT, "configs", "pointpillars_kitti.yaml")
FIXTURE = ["data.fixture=true", "data.fixture_size=8",
           "data.augment.enabled=false", "train.ckpt_dir="]

# Each model of the port at a small size: (config, overrides). The last
# four name their key map (``FLAX_KEYS``).
MODELS = {
    "pointpillars_fused": ("pointpillars_tiny", []),
    "second": ("second_tiny", []),
    "pointnet2_partseg": ("pointnet2_partseg_tiny", []),
    "pointpillars_voxel_buffer": ("pointpillars_tiny",
                                  ["model.params.fused=false"]),
    "pointnet_cls": ("pointnet_modelnet40_tiny", []),
    "pointnet2_cls": ("pointnet2_modelnet40", [
        "data.fixture=true", "data.fixture_size=8", "train.batch_size=2"]),
    "rangeseg": ("rangeseg_tiny", []),
}


def _leaves(state):
    """The JAX state's params and batch_stats as flat numpy arrays."""
    out = {}
    for col in ("params", "batch_stats"):
        tree = getattr(state, col)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{col}/{key}"] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_weight_files_cross_both_ways_bit_for_bit(model, tmp_path):
    name, overrides = MODELS[model]
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    jax_pipe = lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(path), overrides))
    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(path), overrides),
        device="cpu")
    if model in ("pointpillars_voxel_buffer", "pointnet_cls",
                 "pointnet2_cls", "rangeseg"):
        assert getattr(port.model, "FLAX_KEYS", None)

    # JAX -> port: the JAX package's snapshot fills every tensor.
    state = jax_pipe.init_state(0)
    jax_file = str(tmp_path / "jax.npz")
    jax_bench_lib.save_weights_npz(state, jax_file)
    bench_lib.load_weights_npz(port.model, jax_file)
    want = _leaves(state)
    got = to_flax_arrays(port.model)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)

    # port -> JAX: the port's own weights (drawn from another seed) load
    # into a JAX state and come back unchanged.
    port.model.reset_parameters(3)
    port_file = str(tmp_path / "port.npz")
    bench_lib.save_weights_npz(port.model, port_file)
    mine = to_flax_arrays(port.model)
    restored = jax_bench_lib.load_weights_npz(jax_pipe.init_state(1),
                                              port_file)
    back = _leaves(restored)
    assert set(back) == set(mine)
    for k, w in mine.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)
    assert any(not np.array_equal(mine[k], want[k]) for k in want)


def test_fixture_batch_equals_jax():
    cfg = apply_overrides(lisec_tpu_torch.load_config(KITTI), FIXTURE)
    got = bench_lib._fixture_batch(cfg, 2)
    want = jax_bench_lib._fixture_batch(
        jax_apply_overrides(jax_load_config(KITTI), FIXTURE), 2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_timer_and_device_sync_on_cpu_tensors(tmp_path):
    """The JAX package's stage timer and device fence are the port's
    spans: under ``trace`` a span times its stage on the host and, given
    a device, on that device's stream (the host's time on the CPU), and
    ``spans()`` reads them after fencing the card's events."""
    clear_spans()
    with trace(str(tmp_path / "prof")):
        for _ in range(3):
            with span("matmul", "cpu"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with span("nothing"):
            pass
    with open(tmp_path / "prof" / "spans.json") as f:
        written = json.load(f)
    assert written == spans()
    assert [s["name"] for s in written] == ["matmul"] * 3 + ["nothing"]
    for s in written:
        assert s["parent"] is None and s["end_ns"] >= s["start_ns"]
    for s in written[:3]:
        assert s["stream_ms"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) * 1e-6)
    assert written[3]["stream_ms"] is None
    assert len({s["request"] for s in written}) == 4
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with span("off", "cpu"):
        pass
    assert len(spans()) == 4
    clear_spans()
    assert spans() == []


def test_ops_exports_are_the_jax_names_the_port_has():
    assert set(ops.__all__) <= set(jax_ops.__all__)
    assert "build_subm_scatter_rulebook" not in ops.__all__
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    # Importing compiled nothing: no kernel library is loaded. Checked in
    # a fresh interpreter, since a test file run before this one in the
    # same worker may have built one.
    res = subprocess.run(
        [sys.executable, "-c", "import lisec_tpu_torch.bench_lib, "
         "lisec_tpu_torch.ops\nfrom lisec_tpu_torch.ops.cuda import build\n"
         "assert build._LIBS == {}, build._LIBS"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
