"""The port's box decoding, rotated IoU and rotated NMS against the JAX
package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisec_tpu.ops.boxes import decode_boxes as jax_decode
from lisec_tpu.ops.nms import rotated_nms as jax_nms
from lisec_tpu.ops.rotated_iou import rotated_iou_bev as jax_iou
from lisec_tpu_torch.ops.boxes import decode_boxes
from lisec_tpu_torch.ops.nms import rotated_nms, top_k
from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev

torch.set_num_threads(1)


def _boxes(rng, n, spread=6.0):
    ctr = rng.uniform(-spread, spread, (n, 3))
    size = rng.uniform([3.0, 1.4, 1.3], [4.5, 2.0, 1.8], (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([ctr, size, yaw], -1).astype(np.float32)


def test_decode_boxes():
    rng = np.random.default_rng(0)
    deltas = rng.normal(size=(4, 500, 7)).astype(np.float32) * 3
    anchors = _boxes(rng, 500)[None].repeat(4, 0)
    want = np.asarray(jax_decode(jnp.asarray(deltas), jnp.asarray(anchors)))
    got = decode_boxes(torch.from_numpy(deltas),
                       torch.from_numpy(anchors)).numpy()
    # Same f32 arithmetic; exp may differ by an ulp between the libraries
    # and a product-sum near zero by an ulp of its terms.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rotated_iou_random_pairs():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 4000, 3.0), _boxes(rng, 4000, 3.0)
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    got = rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0.05).mean() > 0.3          # many real overlaps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rotated_iou_identical_far_boxes():
    rng = np.random.default_rng(2)
    a = _boxes(rng, 64)
    a[:, 0] += 80.0
    got = rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, 1.0, rtol=0, atol=1e-5)
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, 1.0])
    vals, idx = top_k(x, 5)
    assert idx.tolist() == [1, 2, 4, 0, 5]
    assert vals.tolist() == [3.0, 3.0, 3.0, 1.0, 1.0]


def _nms_inputs(rng, b, a, num_classes):
    # Clustered boxes (many overlaps) with scores rounded to 2 decimals,
    # so that many of them tie exactly.
    boxes = np.stack([_boxes(rng, a, 8.0) for _ in range(b)])
    scores = np.round(rng.uniform(0, 1, (b, a)), 2).astype(np.float32)
    labels = rng.integers(0, num_classes, (b, a)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("k_near,select,class_parallel", [
    (0, "topk", 0), (0, "scan", 0), (64, "topk", 0), (64, "scan", 0),
    (64, "topk", 3)])
def test_rotated_nms(k_near, select, class_parallel):
    rng = np.random.default_rng(3)
    boxes, scores, labels = _nms_inputs(rng, 2, 300, class_parallel or 2)
    kw = dict(iou_threshold=0.5, score_threshold=0.1, nms_pre=256,
              nms_post=48, block=16, k_near=k_near, select=select,
              class_parallel=class_parallel)
    got = rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(labels), **kw)
    for i in range(2):
        want = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                       jnp.asarray(labels[i]), **kw)
        assert np.asarray(want.valid).sum() > 10
        np.testing.assert_array_equal(got.valid[i].numpy(), want.valid)
        np.testing.assert_array_equal(got.labels[i].numpy(), want.labels)
        np.testing.assert_allclose(got.boxes[i].numpy(), want.boxes,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.scores[i].numpy(), want.scores,
                                   rtol=0, atol=1e-6)
