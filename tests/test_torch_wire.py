"""The port's int16 wire (``lisec_tpu_torch/data/wire.py``) and
``Pipeline.infer_packed`` against the JAX package's.

Inputs are made with numpy from seeds. ``pack_points_q16`` is compiled
C++ in the port and numpy in the JAX package; the two must agree bit for
bit in every output and dtype, and, where the mask is a prefix, with the
benchmark reference's own numpy pack. The host library is built with
``g++`` at the first pack, never at import. The dequantization
is held bit for bit to the JAX package's jitted program on the CPU,
which contracts the multiply and add into one rounding: every one of the
65,536 codes, at ordinary and extreme bounds.
"""

import hashlib
import json
import os
import subprocess
import sys

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
from portbench.reference.wire import pack_q16 as reference_pack_q16

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kitti(rng, b, n):
    """(b, n, 4) f32 points over KITTI's ranges: x, y, z, intensity."""
    return np.stack([rng.uniform(0, 70, (b, n)), rng.uniform(-40, 40, (b, n)),
                     rng.uniform(-3, 1, (b, n)), rng.uniform(0, 1, (b, n))],
                    axis=-1).astype(np.float32)


def _ties(rng):
    """Points whose ``(p - lo) / scale`` falls exactly half-way between
    two codes, with even and odd integer parts: channel 0 spans [0, 65535]
    (step 1) and channel 1 [0, 4095.9375] (step 1/16); channels 2 and 3
    put their bounds at the first and last valid point, so the codes reach
    both ends of the clip, -32768 and 32767. Padding rows hold values far
    outside the bounds."""
    b, n = 2, 300
    half = rng.integers(0, 65535, (b, n)) + 0.5
    pts = np.stack([half, half / 16, rng.uniform(-7, 9, (b, n)),
                    rng.uniform(1e3, 2e3, (b, n))], axis=-1)
    pts[0, 0, :2] = 0.0
    pts[0, 1, :2] = [65535.0, 4095.9375]
    pts[0, 2, 2:] = [-7.0, 1e3]
    pts[1, 0, 2:] = [9.0, 2e3]
    counts = np.array([n - 20, n - 3])
    mask = np.arange(n)[None, :] < counts[:, None]
    pts[~mask] = 1e30
    return pts.astype(np.float32), mask


def _batch(case, rng):
    """A (B, N, 4) f32 batch and its mask: KITTI-like spans with prefix
    masks of several lengths; holes in the mask; nothing valid; one valid
    point in the whole batch; the benchmark's shape (32 clouds of 19,000
    to 22,000 points in 32,768 rows); an empty cloud among others, with
    NaN and huge values in the padding; every row valid; rounding ties
    and both ends of the clip; float64 points; strided views of points
    and mask."""
    b, n = 3, 257
    if case == "bench_shape":
        b, n = 32, 32768
        counts = rng.integers(19_000, 22_001, b)
        pts = _kitti(rng, b, n)
        mask = np.arange(n)[None, :] < counts[:, None]
        pts[~mask] = 0.0
        return pts, mask
    if case == "ties":
        return _ties(rng)
    pts = _kitti(rng, b, n)
    counts = np.array([n, 100, 1])
    mask = np.arange(n)[None, :] < counts[:, None]
    if case == "non_prefix":
        mask = rng.random((b, n)) > 0.4
    elif case == "all_masked":
        mask[:] = False
    elif case == "single_point":
        mask[:] = False
        mask[1, 17] = True
    elif case == "empty_cloud":
        mask = np.arange(n)[None, :] < np.array([120, 0, 57])[:, None]
        pts[~mask] = np.where(rng.random((~mask).sum()) < 0.5, np.nan,
                              -1e30)[:, None]
    elif case == "full":
        mask[:] = True
    elif case == "float64":
        return pts.astype(np.float64) + rng.uniform(-1e-3, 1e-3, pts.shape), \
            mask
    elif case == "strided":
        wide = np.repeat(pts, 2, axis=1)         # every row twice
        mask2 = np.repeat(rng.random((b, n)) > 0.3, 2, axis=1)
        return wide[:, ::2], mask2[:, 1::2]
    return pts, mask


PACK_CASES = ["random", "non_prefix", "all_masked", "single_point",
              "bench_shape", "empty_cloud", "full", "ties", "float64",
              "strided"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_equals_jax(case):
    pts, mask = _batch(case, np.random.default_rng(len(case)))
    got = wire.pack_points_q16(pts, mask)
    want = jax_wire.pack_points_q16(pts, mask)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].tobytes() == want[k].tobytes(), k    # signs of zero
    counts = mask.sum(1)
    if (mask == (np.arange(mask.shape[1]) < counts[:, None])).all():
        q, lo, scale = reference_pack_q16(pts, counts)
        for k, ref in (("points_q16", q), ("wire_lo", lo),
                       ("wire_scale", scale)):
            assert got[k].tobytes() == ref.tobytes(), k
    if case == "all_masked":
        np.testing.assert_array_equal(got["wire_lo"], 0.0)
        assert (got["points_q16"] == -32768).all()
    if case == "ties":
        valid = np.arange(mask.shape[1]) < counts[:, None]
        p = pts[valid].astype(np.float32)
        x = (p - got["wire_lo"]) / got["wire_scale"]
        frac, whole = np.modf(x[:, :2])
        assert (frac == 0.5).sum() > 500
        assert {0, 1} <= set((whole[frac == 0.5] % 2).astype(int))
        codes = got["points_q16"][valid]
        assert (codes[:, 2:] == -32768).any() and (codes[:, 2:] == 32767).any()
        assert (codes[:, :2] == 32767).any()
    if case == "empty_cloud":
        assert got["num_points"][1] == 0
        assert np.isfinite(got["wire_lo"]).all()


def test_pack_nan_among_valid_points():
    """A NaN among the valid points makes its channel's bounds NaN, as
    numpy's min and max do; the other channels keep theirs, and codes."""
    pts, mask = _batch("random", np.random.default_rng(11))
    pts[1, 40, 2] = np.nan
    pts[2, 200, 0] = np.nan                    # padding: not read
    got = wire.pack_points_q16(pts, mask)
    with np.errstate(invalid="ignore"):
        want = jax_wire.pack_points_q16(pts, mask)
    np.testing.assert_array_equal(got["wire_lo"], want["wire_lo"])
    np.testing.assert_array_equal(got["wire_scale"], want["wire_scale"])
    assert np.isnan(got["wire_lo"]).tolist() == [False, False, True, False]
    keep = [0, 1, 3]
    np.testing.assert_array_equal(got["points_q16"][..., keep],
                                  want["points_q16"][..., keep])
    np.testing.assert_array_equal(got["num_points"], want["num_points"])


def test_pack_refuses_a_mask_of_another_shape():
    pts, mask = _batch("random", np.random.default_rng(0))
    with pytest.raises(ValueError, match="mask"):
        wire.pack_points_q16(pts, mask[:, :-1])
    with pytest.raises(ValueError, match="points"):
        wire.pack_points_q16(pts[0], mask[0])


_BUILD_PROBE = """
import json, subprocess, sys
from pathlib import Path
calls = []
_run = subprocess.run
def run(cmd, *a, **kw):
    calls.append([str(x) for x in cmd])
    return _run(cmd, *a, **kw)
subprocess.run = run
import importlib, pkgutil
import numpy as np
import lisec_tpu_torch
for m in pkgutil.walk_packages(lisec_tpu_torch.__path__, "lisec_tpu_torch."):
    importlib.import_module(m.name)
from lisec_tpu_torch.data import wire
from lisec_tpu_torch.ops.cuda import build
at_import = len(calls)
build.BUILD_DIR = Path(sys.argv[1])
pts = np.arange(32, dtype=np.float32).reshape(2, 4, 4)
wire.pack_points_q16(pts, np.ones((2, 4), bool))
first = list(calls)
wire._pack_entry.cache_clear()
wire.pack_points_q16(pts, np.ones((2, 4), bool))
print(json.dumps({"at_import": at_import, "first": first[at_import:],
                  "again": calls[len(first):],
                  "built": sorted(p.name for p in build.BUILD_DIR.iterdir()),
                  "expect": build.library_path("wire_pack").name}))
"""


def test_host_library_builds_with_gxx_at_first_pack_and_is_reused(tmp_path):
    """Importing every module of the port compiles nothing; the first pack
    runs ``g++`` once (no fast math, no contraction, no host-specific
    code) into a library named by the hash of its source and flags; a
    later binding finds that library and compiles nothing."""
    from lisec_tpu_torch.ops.cuda import build
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _BUILD_PROBE,
                          str(tmp_path / "_build")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["at_import"] == 0
    assert len(out["first"]) == 1 and out["again"] == []
    cmd = out["first"][0]
    assert os.path.basename(cmd[0]) == "g++"
    assert "-O3" in cmd and "-ffp-contract=off" in cmd
    assert not [f for f in cmd if f.startswith(("-march", "-mtune"))
                or "fast-math" in f or f == "-Ofast"]
    src = build.CSRC_DIR / "wire_pack.cc"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(build.HOST_FLAGS).encode())
    assert out["built"] == [out["expect"]] == [
        f"libwire_pack-{digest.hexdigest()[:12]}.so"]


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
