"""The submanifold scatter rulebook (``ops/sparse_conv.py::
build_subm_scatter_rulebook``: half the offsets searched, the centre the
identity, the mirrors inverted by one ``segment_paint``) against the JAX
package's, run with its paint in interpret mode, and against the general
builder of both packages, exactly."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisec_tpu_torch
from lisec_tpu.ops.sparse_conv import SparseConvSpec as JaxSpec
from lisec_tpu.ops.sparse_conv import build_scatter_rulebook as jax_general
from lisec_tpu.ops.sparse_conv import build_subm_scatter_rulebook as jax_subm
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.ops.cuda import segment_paint as paint_mod
from lisec_tpu_torch.ops.sparse_conv import (
    SparseConvSpec, build_scatter_rulebook, build_subm_scatter_rulebook)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (8, 12, 12)                          # tests/test_ops.py's


def _coords(rng, grid, v, n):
    """Unique coords sorted by cell id, valid rows first, -1 after."""
    nz, ny, nx = grid
    lin = np.sort(rng.choice(nz * ny * nx, size=n, replace=False))
    c = np.stack([lin // (ny * nx), (lin // nx) % ny, lin % nx], -1)
    return np.concatenate([c, np.full((v - n, 3), -1)]).astype(np.int32)


def _check(coords, nums, grid, monkeypatch):
    calls = []
    real = paint_mod.segment_paint

    def counted(vals, cell_sorted, **kw):
        calls.append((tuple(vals.shape), kw))
        return real(vals, cell_sorted, **kw)

    monkeypatch.setattr(paint_mod, "segment_paint", counted)
    spec = SparseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1), grid)
    c, n = torch.from_numpy(coords), torch.from_numpy(nums)
    got = build_subm_scatter_rulebook(c, n, spec)
    b, v, _ = coords.shape
    assert got.dtype == torch.int32 and got.shape == (b, 27, v)
    # One paint of one sum channel over the 13 searched offsets' maps.
    assert calls == [((b * 13, v, 1), {"num_cells": v, "num_max": 0})]
    np.testing.assert_array_equal(
        got.numpy(), build_scatter_rulebook(c, n, c, n, spec).numpy())
    jspec = JaxSpec((3, 3, 3), (1, 1, 1), (1, 1, 1), grid)
    jc, jn = jnp.asarray(coords), jnp.asarray(nums)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_subm(jc, jn, jspec)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_general(jc, jn, jc, jn, jspec)))
    return got


@pytest.mark.parametrize("counts", [(40, 17, 64), (0, 5, 64), (64, 64, 64),
                                    (0, 0, 0)],
                         ids=["ragged", "empty", "full", "all_empty"])
def test_subm_rulebook_equals_jax_and_the_general_builder(counts,
                                                          monkeypatch):
    rng = np.random.default_rng(sum(counts))
    coords = np.stack([_coords(rng, GRID, 64, n) for n in counts])
    got = _check(coords, np.asarray(counts, np.int32), GRID, monkeypatch)
    for i, n in enumerate(counts):          # the centre is the identity
        np.testing.assert_array_equal(got[i, 13, :n].numpy(), np.arange(n))
        assert (got[i, :, n:] == -1).all()


def test_subm_rulebook_on_second_tiny_voxels(monkeypatch):
    """Level 0 of the SECOND encoder: the voxels of a ``second_tiny``
    fixture batch on its grid, under a voxel budget the clouds do not
    fill, the second cloud cut to a quarter of its points."""
    cfg = apply_overrides(
        lisec_tpu_torch.load_config(os.path.join(ROOT,
                                                 "configs/second_tiny.yaml")),
        ["data.fixture_size=4", "budget.max_voxels=4096"])
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    batch = next(make_batches(pipe.make_dataset("train"), cfg.budget, 2,
                              shuffle=False))
    batch["point_mask"][1, len(batch["point_mask"][1]) // 4:] = False
    _, coords, _, num = pipe._model_args(pipe.device_batch(batch))
    nums = num.to(torch.int32).numpy()
    assert 0 < nums.min() and nums.max() < coords.shape[1]   # ragged
    _check(coords.numpy(), nums, tuple(reversed(pipe.grid)), monkeypatch)


def test_subm_rulebook_refuses_strided_or_even_kernels():
    c = torch.zeros((1, 4, 3), dtype=torch.int32)
    n = torch.zeros((1,), dtype=torch.int32)
    for spec in (SparseConvSpec((3, 3, 3), (2, 2, 2), (1, 1, 1), GRID),
                 SparseConvSpec((2, 2, 2), (1, 1, 1), (0, 0, 0), GRID)):
        with pytest.raises(ValueError):
            build_subm_scatter_rulebook(c, n, spec)
