"""The port's range-image segmentation (data, range projection, kNN
refinement, network, Lovász loss, weights, pipeline, training) against
the JAX package's.

Inputs are made with numpy from seeds and go through both packages on
the CPU: the port with ``device="cpu"``, where the kernels' wrappers run
their plain versions, the JAX package under ``jit`` with its Pallas
kernels in interpret mode. Every JAX function is called at one shape per
test, so it compiles once.
"""

import os
import types
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data import fixtures as jax_fixtures
from lisec_tpu.pipelines.rangeseg import RangeSegPipeline as JaxRangeSegPipeline
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.data.semantickitti import SemanticKitti as JaxSemanticKitti
from lisec_tpu.models.rangeseg import RangeSegNet as JaxRangeSegNet
from lisec_tpu.ops.range_proj import range_project as jax_range_project
from lisec_tpu.ops.range_proj import (
    range_project_batch as jax_range_project_batch)
from lisec_tpu.ops.range_proj import range_unproject as jax_range_unproject
from lisec_tpu.training.losses import lovasz_softmax as jax_lovasz_softmax
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.data import semantickitti
from lisec_tpu_torch.data.collate import make_batches
from lisec_tpu_torch.data.fixtures import make_semantic_scene
from lisec_tpu_torch.models.common import conv_transpose_same, pad_same
from lisec_tpu_torch.models.rangeseg import RangeSegNet
from lisec_tpu_torch.ops.range_proj import (
    range_project, range_project_batch, range_unproject)
from lisec_tpu_torch.training.losses import lovasz_softmax
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, to_flax_arrays)

# ``lisec_tpu_torch.ops`` exports a function named ``knn_refine`` over its
# module.
port_knn = import_module("lisec_tpu_torch.ops.knn_refine")

torch.set_num_threads(1)

# The JAX ops package exports functions under its modules' names.
jax_knn = import_module("lisec_tpu.ops.knn_refine")
jax_sparse_conv = import_module("lisec_tpu.ops.sparse_conv")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "rangeseg_tiny.yaml")
FULL = os.path.join(ROOT, "configs", "rangeseg_fixture_conv.yaml")
H, W = 16, 128                       # rangeseg_tiny's image
FOV_UP, FOV_DOWN = 3.0, -25.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, col, prefix=""):
    """A flax tree -> flat ``col/prefix/Module_0/.../leaf`` numpy dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{col}/{prefix}" + "/".join(str(p.key) for p in path)] = \
            np.asarray(leaf)
    return out


def _randomize_bn(rng, variables):
    """Non-trivial BN statistics and affine terms in every layer."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        if name in ("var", "scale"):
            return jnp.asarray(0.5 + rng.random(leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(fill, variables)


# -- data --------------------------------------------------------------------

def test_semantic_scene_is_bit_equal_to_jax():
    for seed, n in ((0, 16000), (40_003, 500), (7, 120_000)):
        got = make_semantic_scene(seed, num_points=n)
        want = jax_fixtures.make_semantic_scene(seed, num_points=n)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_label_map_and_reader_match_jax(tmp_path):
    from lisec_tpu.data import semantickitti as jax_sk
    assert semantickitti.LEARNING_MAP == jax_sk.LEARNING_MAP
    raw = np.arange(0, 300, dtype=np.int32)
    np.testing.assert_array_equal(semantickitti.remap_labels(raw),
                                  jax_sk.remap_labels(raw))
    path = tmp_path / "x.label"
    (np.arange(50, dtype=np.uint32) | (np.uint32(3) << 16)).tofile(path)
    np.testing.assert_array_equal(semantickitti.read_label(str(path)),
                                  jax_sk.read_label(str(path)))


@pytest.mark.parametrize("source", ["fixture", "files"])
def test_dataset_and_batches_are_bit_identical(source, tmp_path):
    over = ["budget.max_points=20000", "train.batch_size=2",
            "data.augment.enabled=true"]
    if source == "files":
        jax_fixtures.write_semantickitti_fixture(str(tmp_path), num_scans=3)
        over += ["data.fixture=false", f"data.root={tmp_path}"]
    else:
        over += ["data.fixture_size=4"]
    cfg = apply_overrides(lisec_tpu_torch.load_config(FULL), over)
    jcfg = jax_apply_overrides(jax_load_config(FULL), over)
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    got, want = pipe.make_dataset("train"), JaxSemanticKitti(jcfg, "train")
    assert len(got) == len(want) == (4 if source == "fixture" else 3)
    for i in range(len(want)):
        for k, w in want[i].items():
            np.testing.assert_array_equal(got[i][k], w, err_msg=k)
    if source == "fixture":                     # the held-out seeds
        np.testing.assert_array_equal(
            pipe.make_dataset("val")[1]["points"],
            JaxSemanticKitti(jcfg, "val")[1]["points"])
    # The batch stream is the JAX pipeline's, whose range segmenter
    # augments nothing whatever data.augment says.
    jaug = JaxRangeSegPipeline(jcfg).augment_fn("train")
    assert pipe.augment_fn("val") is None
    for a, w in zip(make_batches(got, cfg.budget, 2, seed=3, epochs=1,
                                 augment_fn=pipe.augment_fn("train")),
                    jax_make_batches(want, jcfg.budget, 2, seed=3, epochs=1,
                                     augment_fn=jaug)):
        assert a.keys() == w.keys() == {"points", "point_mask",
                                        "point_labels"}
        for k in w:
            assert a[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)


# -- range projection --------------------------------------------------------

B_PROJ, N_PROJ = 3, 512
PROJ_CASES = ["random", "duplicates", "masked", "edges"]


def _edge_points(rng, n):
    """Points whose exact pixel coordinate is an integer in u (the first
    W) or in v (the next H), then points beyond the field of view and on
    the yaw seam, which are clamped."""
    yaw = np.pi * (1 - 2 * np.arange(W) / W)
    pitch_u = rng.uniform(np.deg2rad(FOV_DOWN), np.deg2rad(FOV_UP), W)
    fov = np.deg2rad(FOV_UP) - np.deg2rad(FOV_DOWN)
    pitch_v = np.deg2rad(FOV_DOWN) + (1 - np.arange(H) / H) * fov
    yaw_v = rng.uniform(-np.pi, np.pi, H)
    pitch_c = np.deg2rad([10.0, -40.0, 89.0, -89.0, 3.0, -25.0, 0.0, 0.0])
    yaw_c = np.array([0.0, 1.0, 2.0, -2.0, np.pi, -np.pi, np.pi, -np.pi])
    yaws = np.concatenate([yaw, yaw_v, yaw_c])
    pitches = np.concatenate([pitch_u, pitch_v, pitch_c])
    r = rng.uniform(2, 60, len(yaws))
    xyz = np.stack([r * np.cos(pitches) * np.cos(yaws),
                    r * np.cos(pitches) * np.sin(yaws),
                    r * np.sin(pitches)], -1)
    pts = np.concatenate([xyz, rng.random((len(yaws), 1))], -1)
    pad = np.concatenate([rng.normal(size=(n - len(pts), 3)) * [15, 15, 1],
                          rng.random((n - len(pts), 1))], -1)
    return np.concatenate([pts, pad]).astype(np.float32)


def _proj_inputs(case):
    """(B, N, 4) clouds and masks for one projection case."""
    rng = np.random.default_rng(PROJ_CASES.index(case))
    pts = np.concatenate([
        rng.normal(size=(B_PROJ, N_PROJ, 3)) * [12, 12, 1.2],
        rng.random((B_PROJ, N_PROJ, 1))], -1).astype(np.float32)
    mask = np.ones((B_PROJ, N_PROJ), bool)
    if case == "duplicates":            # min-range ties: the lower index
        pts[:, 100:200] = pts[:, 0:100]
        pts[:, 300:310] = pts[:, 5:6]
    elif case == "masked":
        mask = rng.random((B_PROJ, N_PROJ)) > 0.4
        mask[2] = False
        pts[0, ~mask[0]] = 0.0          # masked points at the origin too
    elif case == "edges":
        for b in range(B_PROJ):
            pts[b] = _edge_points(rng, N_PROJ)
        pts[1, 400:] = 0.0              # valid points at the origin
    return pts, mask


@pytest.fixture(scope="module")
def jax_proj():
    """The jitted JAX projections, compiled once for (B, N) clouds."""
    single = jax.jit(jax.vmap(lambda p, m: jax_range_project(
        p, m, height=H, width=W, fov_up_deg=FOV_UP, fov_down_deg=FOV_DOWN)))
    batch = jax.jit(lambda p, m: jax_range_project_batch(
        p, m, height=H, width=W, fov_up_deg=FOV_UP, fov_down_deg=FOV_DOWN,
        interpret=True))
    return single, batch


_EXACT = ("image_mask", "pixel_uv", "winner_idx", "pixel_pix", "point_range")


@pytest.mark.parametrize("case", PROJ_CASES)
def test_range_project_matches_jitted_jax(case, jax_proj):
    """The oracle and the main path against the jitted JAX functions:
    the integers and the ranges exactly, the image exactly against the
    vmapped two-scatter form and to 1e-5 relative against the batch
    form, whose paint routes f32 through two bf16 terms."""
    pts, mask = _proj_inputs(case)
    single, batch = jax_proj
    want = single(jnp.asarray(pts), jnp.asarray(mask))
    want_b = batch(jnp.asarray(pts), jnp.asarray(mask))
    got_b = range_project_batch(_t(pts), _t(mask), height=H, width=W)
    for b in range(B_PROJ):
        got = range_project(_t(pts[b]), _t(mask[b]), height=H, width=W)
        for k in (*_EXACT, "image"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k))[b],
                                          err_msg=f"single {k}")
    for k in (*_EXACT, "image"):
        np.testing.assert_array_equal(getattr(got_b, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"batch {k}")
    for k in _EXACT:
        np.testing.assert_array_equal(getattr(got_b, k).numpy(),
                                      np.asarray(getattr(want_b, k)),
                                      err_msg=f"batch form {k}")
    np.testing.assert_allclose(got_b.image.numpy(), np.asarray(want_b.image),
                               rtol=1e-5, atol=0)
    assert got_b.pixel_uv.dtype == got_b.winner_idx.dtype == torch.int32
    if case == "edges":
        # Clamped seam and out-of-view points sit on the image's border.
        uv = got_b.pixel_uv[:, W + H:W + H + 8].numpy()
        assert (uv[..., 0] == 0).any() and (uv[..., 0] == H - 1).any()
        assert (uv[..., 1] == W - 1).any()


def test_range_unproject_reads_the_winner():
    pts, mask = _proj_inputs("duplicates")
    proj = range_project(_t(pts[0]), _t(mask[0]), height=H, width=W)
    got = range_unproject(proj.image[..., 0], proj.pixel_uv)
    want = jax_range_unproject(jnp.asarray(proj.image[..., 0].numpy()),
                               jnp.asarray(proj.pixel_uv.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got <= proj.point_range + 1e-5).all()


# -- kNN refinement ----------------------------------------------------------

B_KNN, N_KNN, H_KNN, W_KNN, NC = 2, 512, 16, 64, 8
KNN_CASES = ["random", "deep_pixel", "empty_window", "cutoff"]


def _knn_inputs(case):
    """Range, label and mask images and points near their pixel's range.
    The image ranges are multiples of 2^-8 below 64: the JAX spread routes
    f32 values through two bf16 terms, which carry such values exactly,
    so both sides refine from the same neighbour ranges."""
    rng = np.random.default_rng(KNN_CASES.index(case))
    b, n, h, w = B_KNN, N_KNN, H_KNN, W_KNN
    img_r = np.round(rng.uniform(1, 30, (b, h, w)) * 256) / 256
    img_l = rng.integers(0, NC, (b, h, w)).astype(np.int32)
    img_m = rng.random((b, h, w)) > 0.2
    uv = np.stack([rng.integers(0, h, (b, n)), rng.integers(0, w, (b, n))],
                  -1)
    if case == "deep_pixel":            # 100 points in one pixel
        uv[:, 50:150] = (3, 7)
    if case == "empty_window":          # no valid neighbour near (8, 32)
        img_m[:, 5:12, 25:40] = False
        uv[:, :60] = np.stack([rng.integers(7, 10, 60),
                               rng.integers(29, 36, 60)], -1)
    pix = (uv[..., 0] * w + uv[..., 1]).astype(np.int32)
    pr = np.take_along_axis(img_r.reshape(b, -1), pix, 1) \
        + rng.normal(0, 0.3, (b, n))
    pr[:, ::13] += 10.0
    if case == "cutoff":                # every neighbour beyond the cutoff
        pr[:, :200] += 40.0
    return (pr.astype(np.float32), pix, img_r.astype(np.float32), img_l,
            img_m)


@pytest.fixture(scope="module")
def jax_knn_fn():
    return jax.jit(lambda *a: jax_knn.knn_refine_batch(
        *a, window=5, k=5, num_classes=NC, interpret=True))


@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_refine_batch_matches_jax(case, jax_knn_fn):
    args = _knn_inputs(case)
    want = np.asarray(jax_knn_fn(*(jnp.asarray(a) for a in args)))
    got = port_knn.knn_refine_batch(*(_t(a) for a in args), window=5, k=5,
                                    num_classes=NC)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The case reaches the fallback it is about.
    fb = np.take_along_axis(args[3].reshape(B_KNN, -1), args[1], 1)
    if case == "cutoff":
        np.testing.assert_array_equal(want[:, :200], fb[:, :200])
    if case == "deep_pixel":
        assert (want[:, 90:150] == fb[:, 90:150]).all()


def test_knn_refine_single_cloud_matches_jax():
    pr, pix, img_r, img_l, img_m = _knn_inputs("random")
    uv = np.stack([pix[0] // W_KNN, pix[0] % W_KNN], -1).astype(np.int32)
    want = np.asarray(jax_knn.knn_refine(
        *(jnp.asarray(a) for a in (pr[0], uv, img_r[0], img_l[0],
                                   img_m[0])), num_classes=NC))
    got = port_knn.knn_refine(*(_t(a) for a in (pr[0], uv, img_r[0],
                                                img_l[0], img_m[0])),
                              num_classes=NC)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_and_delivery_match_jax(monkeypatch):
    """The window table, each pixel's first point (``tgt``) and the
    delivered rows exactly equal to JAX's; the port's padding channels
    are zero."""
    pr, pix, img_r, img_l, img_m = _knn_inputs("deep_pixel")
    spread = jax_sparse_conv._monotone_spread_cols
    # The JAX delivery hands its targets to the spread: return both.
    monkeypatch.setattr(
        jax_sparse_conv, "_monotone_spread_cols",
        lambda vals, tgt, valid, n, interp: (
            spread(vals, tgt, valid, n, interp), tgt))
    hw, s2 = H_KNN * W_KNN, 25

    @jax.jit
    def jax_side(img_r, img_l, img_m, pix):
        cols = jax_knn._build_table_cols(img_r, img_l, img_m, 2, s2)
        pix_s = jnp.sort(pix, axis=1)
        return cols, jax_knn._deliver_rows(cols, pix_s, hw, N_KNN, True)
    cols, (rows, tgt) = jax_side(*(jnp.asarray(a)
                                   for a in (img_r, img_l, img_m, pix)))
    table = port_knn._build_table(_t(img_r), _t(img_l), _t(img_m), 5)
    assert table.shape == (B_KNN, hw, 52)
    np.testing.assert_array_equal(table[..., :50].numpy(),
                                  np.asarray(cols).transpose(0, 2, 1))
    assert not table[..., 50:].any()
    pix_s, _, _ = port_knn._sort_points(_t(pix), _t(pr))
    got_rows, got_tgt = port_knn._deliver_rows(table, pix_s)
    np.testing.assert_array_equal(got_tgt.numpy(), np.asarray(tgt))
    np.testing.assert_array_equal(got_rows[..., :50].numpy(),
                                  np.asarray(rows))
    assert not got_rows[..., 50:].any()
    assert (got_tgt >= 0).sum() < hw and (got_tgt == -1).any()


# -- Lovász-softmax ----------------------------------------------------------

def test_lovasz_softmax_value_and_gradient_match_jax():
    """Value and gradient with respect to the probabilities, with many
    tied errors (every pixel's logits one of four rows): a sort that
    orders ties differently moves the gradient."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 6))[rng.integers(0, 4, (2, 8, 32))]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    labels = rng.integers(-1, 5, (2, 8, 32)).astype(np.int32)  # class 5 absent
    mask = rng.random((2, 8, 32)) > 0.2
    errs = np.abs((labels[..., None] == np.arange(6)) - probs)
    assert len(np.unique(errs)) < errs.size / 20      # ties are plenty

    def jloss(p):
        return jax_lovasz_softmax(p, jnp.asarray(labels), num_classes=6,
                                  mask=jnp.asarray(mask))
    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(probs))
    p = _t(probs).requires_grad_()
    got = lovasz_softmax(p, _t(labels), num_classes=6, mask=_t(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)
    # An unstable order of the ties would give another gradient.
    assert np.abs(np.asarray(want_g)).max() > 1e-3


# -- the network -------------------------------------------------------------

def test_pad_same_takes_a_stride_per_axis():
    x = torch.zeros((1, 1, 16, 128))
    assert pad_same(x, 3, (1, 2)).shape == (1, 1, 18, 129)
    assert pad_same(x, 3, (2, 2)).shape == (1, 1, 17, 129)
    assert pad_same(x, 3, 2).shape == (1, 1, 17, 129)
    assert pad_same(x, 3, 1).shape == (1, 1, 18, 130)


@pytest.mark.parametrize("stride", [(1, 2), (2, 2), (2, 1), (1, 1), (2, 3)])
def test_transposed_conv_matches_flax(stride):
    rng = np.random.default_rng(sum(stride))
    x = rng.normal(size=(2, 6, 10, 7)).astype(np.float32)
    mod = linen.ConvTranspose(5, (3, 3), strides=stride, use_bias=False)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    kernel = np.asarray(v["params"]["kernel"])
    (name, w), = convert_flax_arrays(
        {"params/ConvTranspose_0/kernel": kernel}).items()
    assert name == "up.0.weight"
    got = conv_transpose_same(_t(x).permute(0, 3, 1, 2), w, stride)
    assert got.shape[2:] == (6 * stride[0], 10 * stride[1])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_network_matches_flax(train):
    """RangeSegNet (three levels: both transposed strides) with weights
    carried across, f32: logits within 1e-5 of the largest; in train mode
    the running statistics too."""
    rng = np.random.default_rng(int(train))
    x = rng.normal(size=(2, 8, 32, 5)).astype(np.float32)
    jnet = JaxRangeSegNet(num_classes=6, widths=(8, 12, 16, 20))
    v = _randomize_bn(rng, jax.jit(lambda a: jnet.init(
        jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x)))
    want, new = jax.jit(lambda a: jnet.apply(
        v, a, train=train,
        mutable=["batch_stats"] if train else []))(jnp.asarray(x))
    flat = {**_flat(v["params"], "params"),
            **_flat(v["batch_stats"], "batch_stats")}
    net = RangeSegNet(num_classes=6, widths=(8, 12, 16, 20))
    net.load_state_dict(convert_flax_arrays(flat), strict=True)
    net.train(train)
    with torch.no_grad():
        got = net(_t(x))
    assert got.shape == (2, 8, 32, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if train:
        back = to_flax_arrays(net)
        for k, w in _flat(new["batch_stats"], "batch_stats").items():
            np.testing.assert_allclose(back[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_residual_projection_where_the_width_changes():
    """The residual's bias-free 1x1 conv (which RangeSegNet's own blocks
    never need) against flax's ``_ResBlock``."""
    from lisec_tpu.models.rangeseg import _ResBlock as JaxResBlock
    from lisec_tpu_torch.models.rangeseg import ResBlock
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 9, 4)).astype(np.float32)
    jblock = JaxResBlock(7)
    v = _randomize_bn(rng, jblock.init(jax.random.PRNGKey(2),
                                       jnp.asarray(x)))
    want = np.asarray(jblock.apply(v, jnp.asarray(x)))
    # A top-level ConvTranspose key marks the arrays as RangeSegNet's.
    flat = {**_flat(v["params"], "params", "_ResBlock_0/"),
            **_flat(v["batch_stats"], "batch_stats", "_ResBlock_0/"),
            "params/ConvTranspose_0/kernel": np.zeros((3, 3, 1, 1))}
    state = convert_flax_arrays(flat)
    block = ResBlock(4, 7).eval()
    block.load_state_dict({k[len("blocks.0."):]: t for k, t in state.items()
                           if k.startswith("blocks.0.")}, strict=True)
    with torch.no_grad():
        got = block(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- weights, pipeline, training ---------------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    return lisec_tpu.build_model(jax_load_config(TINY))


@pytest.fixture(scope="module")
def port_pipe():
    return lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(TINY),
                                       device="cpu")


@pytest.fixture(scope="module")
def tiny_state(jax_pipe, tmp_path_factory):
    """JAX ``init_state(0)``'s weights (its ``init_variables`` under
    ``jit``, which draws the same bits), its first unshuffled batch, and
    the same weights in an .npz for the port."""
    dummy = jax.tree.map(jnp.asarray, jax_pipe.dummy_batch())
    v = jax.jit(jax_pipe.init_variables)(jax.random.PRNGKey(0), dummy)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    cfg = jax_pipe.cfg
    batch = next(jax_make_batches(
        jax_pipe.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=False))
    path = str(tmp_path_factory.mktemp("rangeseg") / "init.npz")
    save_weights_npz(state, path)
    return state, batch, path


def test_weights_round_trip_every_key(port_pipe, tiny_state):
    _, _, path = tiny_state
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    state = convert_flax_arrays(flat)
    model = port_pipe.model
    assert len(state) == len(flat) == len(model.state_dict()) == 67
    load_weights_npz(model, path)
    back = to_flax_arrays(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # Every top-level ConvTranspose_i is flipped, not permuted as a conv.
    for i in range(2):
        k = f"params/ConvTranspose_{i}/kernel"
        np.testing.assert_array_equal(
            state[f"up.{i}.weight"].numpy(),
            np.flip(flat[k].transpose(2, 3, 0, 1), (2, 3)))
    assert state["head.bias"].shape == (8,)
    assert state["up.1.scale"].shape == (16,)      # BatchNorm_3
    with pytest.raises(KeyError):
        convert_flax_arrays({**flat, "params/Dense_0/kernel": flat[k]})


def test_tiny_predict_matches_golden_and_jax(jax_pipe, port_pipe,
                                             tiny_state):
    state, batch, path = tiny_state
    want = jax.device_get(jax_pipe.infer(state, batch))
    load_weights_npz(port_pipe.model, path)
    got = lisec_tpu_torch.infer(port_pipe, batch, device="cpu")
    assert got["labels"].dtype == got["pixel_labels"].dtype == torch.int32
    golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                  "rangeseg_tiny.npz"))
    np.testing.assert_array_equal(got["labels"].numpy(), golden["labels"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    # Pixels whose JAX top-two logits lie within 1e-5 of the largest may
    # differ (the JAX image is routed through bf16 terms): none did.
    proj = jax_pipe._project(jnp.asarray(batch["points"]),
                             jnp.asarray(batch["point_mask"]))
    logits = np.asarray(jax_pipe.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        proj.image, train=False))
    top2 = np.sort(logits, -1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 1e-5 * np.abs(logits).max()
    differ = got["pixel_labels"].numpy() != want["pixel_labels"]
    assert not (differ & ~near).any()
    assert differ.sum() == 0 and near.sum() < 0.001 * near.size, (
        int(differ.sum()), int(near.sum()))
    assert not port_pipe.model.training


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_pipeline_loss_and_gradients_match_jax(jax_pipe, port_pipe,
                                               tiny_state):
    """Train-mode ``pipeline.loss`` of both packages from the same weights
    and batch: the loss to 1e-5 (measured 6e-8), the accuracy exactly,
    the running statistics to 1e-4, every gradient within 0.05 of its L2
    norm (measured 0.0055 at worst: the train-mode BNs sum their
    statistics in another order, and the JAX image is routed through two
    bf16 terms)."""
    state, batch, path = tiny_state
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_loss_and_grad(params):
        return jax.value_and_grad(
            lambda p: jax_pipe.loss(p, state.batch_stats, jbatch,
                                    jax.random.PRNGKey(0), train=True),
            has_aux=True)(params)
    (want, (want_aux, new_bs)), grads = jax_loss_and_grad(state.params)
    want_grads = _flat(grads, "params")

    pipe = port_pipe
    load_weights_npz(pipe.model, path)
    pipe.model.train()
    pipe.model.zero_grad()
    try:
        total, aux = pipe.loss(pipe.device_batch(batch))
        total.backward()
    finally:
        pipe.model.eval()
    total = total.detach()
    got_grads = to_flax_arrays(pipe.model, {
        n: p.grad for n, p in pipe.model.named_parameters()})
    got_state = to_flax_arrays(pipe.model)

    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    for k in ("ce", "lovasz"):
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-5, err_msg=k)
    assert float(aux["acc"]) == float(want_aux["acc"])
    for k, w in _flat(new_bs, "batch_stats").items():
        np.testing.assert_allclose(got_state[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert set(got_grads) == set(want_grads)
    gnorm = float(optax.global_norm(grads))
    np.testing.assert_allclose(
        np.sqrt(sum(float((g ** 2).sum()) for g in got_grads.values())),
        gnorm, rtol=1e-3)
    worst = max(_rel(got_grads[k], w) for k, w in want_grads.items()
                if np.linalg.norm(w) > 1e-6 * gnorm)
    assert worst < 0.05, worst


def test_train_lowers_loss_on_tiny():
    cfg = apply_overrides(lisec_tpu_torch.load_config(TINY), [
        "train.num_steps=8", "train.log_every=4", "data.fixture_size=4",
        "budget.max_points=2048", "train.batch_size=2"])
    pipe, history = lisec_tpu_torch.train(cfg, device="cpu", progress=False)
    assert [h["step"] for h in history] == [1, 4, 8]
    assert set(history[0]) == {"step", "lr", "clouds_per_sec", "loss",
                               "grad_norm", "ce", "lovasz", "acc"}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[-1]["loss"] < history[0]["loss"]
    assert pipe.step == 8 and pipe.model.training


def test_rangeseg_is_registered_seed_initialised_and_needs_a_card():
    from lisec_tpu_torch.pipelines.rangeseg import RangeSegPipeline
    from lisec_tpu_torch.registry import get_model, get_pipeline
    assert get_pipeline("rangeseg") is RangeSegPipeline
    assert get_model("rangeseg") is RangeSegNet
    cfg = lisec_tpu_torch.load_config(TINY)
    pipes = [RangeSegPipeline(cfg, device="cpu", seed=s) for s in (0, 0, 1)]
    s0, s1, s2 = (p.model.state_dict() for p in pipes)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    w = s0["blocks.0.conv.0.weight"]
    assert not torch.equal(w, s2["blocks.0.conv.0.weight"])
    np.testing.assert_allclose(float(w.std()), (9 * 32) ** -0.5, rtol=0.1)
    assert not pipes[0].model.training
    assert set(pipes[0].evaluate(max_batches=1)) == {"miou", "miou_all"}
    full = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(FULL),
                                       device="cpu")
    assert full.model.dtype == torch.bfloat16
    assert full.augment_fn("train") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            lisec_tpu_torch.build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            lisec_tpu_torch.build_model(cfg, device="cuda")
