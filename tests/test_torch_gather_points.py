"""``ops.gather_points`` (the row gather kernel's wrapper on a CUDA tensor,
its plain version on a CPU one) and ``eval.detection.iou_3d_np`` against
the JAX package's, exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.eval.detection import iou_3d_np as jax_iou_3d_np
from lisec_tpu.ops import gather_points as jax_gather_points
from lisec_tpu_torch import ops
from lisec_tpu_torch.eval.detection import iou_3d_np


@pytest.mark.parametrize("points_shape,m", [((2, 64, 3), 16),
                                            ((3, 2, 50, 5), 7),
                                            ((40, 4), 40)],
                         ids=["batch", "two_leading_dims", "one_cloud"])
def test_gather_points_equals_jax(points_shape, m):
    rng = np.random.default_rng(len(points_shape) + m)
    pts = rng.normal(size=points_shape).astype(np.float32)
    idx = rng.integers(0, points_shape[-2],
                       size=points_shape[:-2] + (m,)).astype(np.int32)
    want = np.asarray(jax_gather_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = ops.gather_points(torch.from_numpy(pts), torch.from_numpy(idx))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_points_gradient_equals_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(2, 32, 3)).astype(np.float32)
    idx = rng.integers(0, 32, size=(2, 48)).astype(np.int32)   # repeats
    w = rng.normal(size=(2, 48, 3)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jax_gather_points(
        p, jnp.asarray(idx)) * w))(jnp.asarray(pts))
    p = torch.from_numpy(pts).requires_grad_()
    (ops.gather_points(p, torch.from_numpy(idx)) * torch.from_numpy(w)
     ).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_iou_3d_np_equals_jax():
    rng = np.random.default_rng(3)
    boxes = np.concatenate([rng.uniform(-3, 3, (24, 3)),
                            rng.uniform(0.5, 4, (24, 3)),
                            rng.uniform(-np.pi, np.pi, (24, 1))], 1)
    boxes[1] = boxes[0]                              # identical
    boxes[3] = boxes[2] + [20, 0, 0, 0, 0, 0, 0]     # disjoint
    for a in boxes[:12]:
        for b in boxes[12:]:
            assert iou_3d_np(a, b) == jax_iou_3d_np(a, b)
    assert iou_3d_np(boxes[0], boxes[1]) == pytest.approx(1.0)
    assert iou_3d_np(boxes[2], boxes[3]) == 0.0
