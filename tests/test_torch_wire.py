"""The port's int16 wire (``lisec_tpu_torch/data/wire.py``) and
``Pipeline.infer_packed`` against the JAX package's.

Inputs are made with numpy from seeds. ``pack_points_q16`` is numpy on
both sides and must agree in every output and dtype. The dequantization
is held bit for bit to the JAX package's jitted program on the CPU,
which contracts the multiply and add into one rounding: every one of the
65,536 codes, at ordinary and extreme bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches
from lisec_tpu.data import wire as jax_wire
from lisec_tpu_torch.data import wire
from lisec_tpu_torch.weights import load_weights_npz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(case, rng):
    """A (B, N, 4) f32 batch and its mask: KITTI-like spans with prefix
    masks of several lengths; holes in the mask; nothing valid; one valid
    point in the whole batch."""
    b, n = 3, 257
    pts = np.stack([rng.uniform(0, 70, (b, n)), rng.uniform(-40, 40, (b, n)),
                    rng.uniform(-3, 1, (b, n)), rng.uniform(0, 1, (b, n))],
                   axis=-1).astype(np.float32)
    counts = np.array([n, 100, 1])
    mask = np.arange(n)[None, :] < counts[:, None]
    if case == "non_prefix":
        mask = rng.random((b, n)) > 0.4
    elif case == "all_masked":
        mask[:] = False
    elif case == "single_point":
        mask[:] = False
        mask[1, 17] = True
    return pts, mask


@pytest.mark.parametrize("case", ["random", "non_prefix", "all_masked",
                                  "single_point"])
def test_pack_equals_jax(case):
    pts, mask = _batch(case, np.random.default_rng(len(case)))
    got = wire.pack_points_q16(pts, mask)
    want = jax_wire.pack_points_q16(pts, mask)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "all_masked":
        np.testing.assert_array_equal(got["wire_lo"], 0.0)
        assert (got["points_q16"] == -32768).all()


# Per channel (lo, scale): KITTI's bounds; a tiny scale beside tiny,
# large and near-overflow offsets; huge scales; subnormal bounds, which
# XLA on the CPU takes as zero.
BOUNDS = {
    "kitti": ([0.0, -39.68, -3.0, 0.0],
              [69.12 / 65535, 79.36 / 65535, 4.0 / 65535, 1.0 / 65535]),
    "tiny_scale": ([1e-30, -1e-30, 12345.678, -3e38],
                   [1e-6 / 65535, 3.3e-6 / 65535, 1e-3, 9.15e33]),
    "huge": ([1e20, -1e20, 3e38, -1.0], [3e15, 3e15, 1e30, 1.0]),
    "subnormal": ([1e-40, -1e-40, 0.0, -0.0], [1.5e-11, 1e-45, 1.0, 2.0]),
}


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
def test_dequantize_bit_equal_to_jitted_jax(bounds):
    lo, scale = (np.asarray(v, np.float32) for v in BOUNDS[bounds])
    codes = np.arange(-32768, 32768).astype(np.int16)
    q = np.stack([np.repeat(codes[:, None], 4, 1),
                  np.repeat(codes[::-1, None], 4, 1)])      # (2, 65536, 4)
    packed = {"points_q16": q, "num_points": np.array([65536, 123], np.int32),
              "wire_lo": lo, "wire_scale": scale,
              "gt_boxes": np.ones((2, 3, 7), np.float32)}
    want = jax.jit(jax_wire.unpack_points_q16)(
        {k: jnp.asarray(v) for k, v in packed.items()})
    got = wire.unpack_points_q16(
        {k: torch.from_numpy(v) for k, v in packed.items()})
    assert set(got) == set(want) == {"points", "point_mask", "gt_boxes"}
    assert got["points"].dtype == torch.float32
    assert got["point_mask"].dtype == torch.bool
    np.testing.assert_array_equal(got["points"].numpy().view(np.int32),
                                  np.asarray(want["points"]).view(np.int32))
    np.testing.assert_array_equal(got["point_mask"].numpy(),
                                  np.asarray(want["point_mask"]))
    np.testing.assert_array_equal(got["gt_boxes"].numpy(), packed["gt_boxes"])


def test_round_trip_error_below_half_a_step():
    """Dequantized points lie within half a step (plus the f32 rounding
    of the offset) of the originals, in the original order."""
    pts, mask = _batch("non_prefix", np.random.default_rng(3))
    packed = wire.pack_points_q16(pts, mask)
    out = wire.unpack_points_q16({k: torch.from_numpy(v)
                                  for k, v in packed.items()})
    step = packed["wire_scale"]
    for i in range(len(pts)):
        n = int(mask[i].sum())
        got = out["points"][i, :n].numpy()
        err = np.abs(got - pts[i][mask[i]])
        assert (err <= 0.5 * step + 1e-5 * np.abs(pts[i][mask[i]])).all()
        assert out["point_mask"][i].sum() == n
        assert out["point_mask"][i, :n].all()


def _spread_scores(state):
    """The state with its class head's kernel times 1000. Seed weights
    give every anchor nearly the prior's score (second_tiny keeps no box
    at its threshold); scaled up, the scores spread far wider than the
    two packages' f32 differences, so the keep sets are determined."""
    head = dict(state.params["AnchorHead_0"])
    head["Conv_0"] = {**head["Conv_0"],
                      "kernel": head["Conv_0"]["kernel"] * 1000.0}
    return state.replace(params={**state.params, "AnchorHead_0": head})


@pytest.fixture(scope="module", params=["pointpillars_tiny", "second_tiny"])
def tiny(request, tmp_path_factory):
    """Both packages' pipelines of one tiny config with the JAX
    package's ``init_state(0)`` weights (class head scaled by
    ``_spread_scores``), and its first val batch packed."""
    path = os.path.join(ROOT, "configs", f"{request.param}.yaml")
    jax_pipe = lisec_tpu.build_model(jax_load_config(path))
    state = _spread_scores(jax_pipe.init_state(0))
    cfg = jax_pipe.cfg
    batch = next(make_batches(jax_pipe.make_dataset("val"), cfg.budget,
                              cfg.train.batch_size, shuffle=False, epochs=1))
    weights = str(tmp_path_factory.mktemp("wire") / "init.npz")
    save_weights_npz(state, weights)
    port = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(path),
                                       device="cpu")
    load_weights_npz(port.model, weights)
    packed = wire.pack_points_q16(batch["points"], batch["point_mask"])
    return jax_pipe, state, port, packed


def test_infer_packed_equals_infer_on_the_dequantized_batch(tiny):
    _, _, port, packed = tiny
    got = port.infer_packed(packed)
    deq = wire.unpack_points_q16({k: torch.from_numpy(v)
                                  for k, v in packed.items()})
    want = port.infer({k: deq[k] for k in ("points", "point_mask")})
    assert not port.model.training
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cpu"
        assert torch.equal(got[k], want[k]), k
    assert bool(got["valid"].any())


def test_infer_packed_matches_jax(tiny):
    jax_pipe, state, port, packed = tiny
    want = jax.device_get(jax_pipe.infer_packed(state, packed))
    got = {k: v.numpy() for k, v in port.infer_packed(packed).items()}
    # Keep sets and labels exactly; boxes and scores to the tolerance of
    # tests/test_torch_pointpillars.py::test_tiny_predict_matches_golden_and_jax.
    assert want["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
