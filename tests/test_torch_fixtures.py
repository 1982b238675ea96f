"""The port's fixture writers (``data/fixtures.py``: KITTI, SemanticKITTI
and ModelNet40 layouts) write the JAX package's file trees byte for byte,
and the port's loaders read the trees they write as the JAX loaders read
theirs."""

from __future__ import annotations

import os

import numpy as np
import pytest

import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data import fixtures as jax_fixtures
from lisec_tpu.data.kitti import KittiDetection as JaxKitti
from lisec_tpu.data.modelnet40 import ModelNet40 as JaxModelNet40
from lisec_tpu.data.semantickitti import SemanticKitti as JaxSemanticKitti
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data import (
    KittiDetection, ModelNet40, SemanticKitti, fixtures)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# writer, its arguments, the config its loader reads, the loader pair.
CASES = {
    "kitti": ("write_kitti_fixture", {"num_frames": 3, "seed": 3},
              "pointpillars_tiny.yaml", KittiDetection, JaxKitti),
    "semantickitti": ("write_semantickitti_fixture",
                      {"num_scans": 2, "seed": 1}, "rangeseg_tiny.yaml",
                      SemanticKitti, JaxSemanticKitti),
    "modelnet": ("write_modelnet_fixture",
                 {"num_per_class": 2, "num_classes": 4, "seed": 2},
                 "pointnet_modelnet40_tiny.yaml", ModelNet40, JaxModelNet40),
}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_writers_write_the_jax_trees_and_the_loaders_read_them(case,
                                                               tmp_path):
    writer, kwargs, config, port_cls, jax_cls = CASES[case]
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    getattr(fixtures, writer)(str(mine), **kwargs)
    getattr(jax_fixtures, writer)(str(theirs), **kwargs)
    got, want = _tree(mine), _tree(theirs)
    assert sorted(got) == sorted(want) and len(got) >= 3
    for name, data in want.items():
        assert got[name] == data, name

    path = os.path.join(ROOT, "configs", config)
    over = ["data.fixture=false"]
    cfg = apply_overrides(lisec_tpu_torch.load_config(path),
                          over + [f"data.root={mine}"])
    jcfg = jax_apply_overrides(jax_load_config(path),
                               over + [f"data.root={theirs}"])
    port_ds, jax_ds = port_cls(cfg, "train"), jax_cls(jcfg, "train")
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        a, w = port_ds[i], jax_ds[i]
        assert a.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert a[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(a[k], w[k], err_msg=k)
            else:
                assert a[k] == w[k], k
