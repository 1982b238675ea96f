"""The port's copy of the reference's random streams (``utils/prng.py``)
and the ``threefry`` kernel's plain version, held against ``jax.random``,
``jax.nn.initializers`` and flax on the CPU.

Keys, bits, uniforms, Bernoulli masks, flax's path keys, ``erf``,
``log1p``, ``erf_inv``, truncated normals and the initializers are all
bit-equal to JAX's here (JAX 0.9.0, flax 0.12.3, partitionable
threefry): the tests assert equality, so the tolerance of the draw is
0 ulp and its bit-equal share 100%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static
from jax._src.prng import threefry2x32_p

from lisec_tpu_torch.ops.cuda import threefry
from lisec_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 17, 2 ** 31 - 1, -1, 2 ** 31, 2 ** 32 + 5, 2 ** 40 + 3,
         -2 ** 63, 2 ** 63 - 1]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for data in (0, 1, 17, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(key, data),
            np.asarray(jax.random.fold_in(jkey, data)))
    np.testing.assert_array_equal(prng.split(key, 5),
                                  np.asarray(jax.random.split(jkey, 5)))


def test_seed_out_of_int64_range_raises_as_in_jax():
    for seed in (2 ** 63, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng.PRNGKey(seed)


def test_bits_uniform_and_bernoulli_equal_jax_on_a_million():
    key = prng.PRNGKey(23)
    jkey = jax.random.PRNGKey(23)
    shape = (1000, 1000)
    np.testing.assert_array_equal(
        prng.random_bits(key, shape),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    np.testing.assert_array_equal(
        prng.uniform(key, shape), np.asarray(jax.random.uniform(jkey, shape)))
    np.testing.assert_array_equal(
        prng.uniform(key, shape, -0.3, 2.7),
        np.asarray(jax.random.uniform(jkey, shape, minval=-0.3, maxval=2.7)))
    for p in (0.6, 0.5, 0.9):
        np.testing.assert_array_equal(
            prng.bernoulli(key, p, shape),
            np.asarray(jax.random.bernoulli(jkey, p, shape)))


@pytest.mark.parametrize("offset", [0, 3, 2 ** 32 - 5, 2 ** 40 + 11])
def test_bits_at_an_offset_are_the_stream_from_that_index(offset):
    """Element i of ``random_bits(key, shape, offset)`` is threefry of
    (hi, lo) of offset + i, as JAX's own hash computes it, also where the
    index crosses 2**32 (more elements than JAX can draw at once)."""
    key = prng.PRNGKey(9)
    idx = np.arange(37, dtype=np.uint64) + np.uint64(offset)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                 jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(y0) ^ np.asarray(y1)
    np.testing.assert_array_equal(prng.random_bits(key, (37,), offset), want)
    if offset == 0:
        np.testing.assert_array_equal(
            want, np.asarray(jax.random.bits(jax.random.PRNGKey(9), (37,),
                                             jnp.uint32)))


@pytest.mark.parametrize("path", [
    ("a", 1), ("BEVBackbone_0", "ConvBNRelu_3", "Conv_0", 1),
    ("MLPHead_0", "Dropout_1", 1), ("x", 0), ("TNet_1", 2 ** 40),
    ("Dense_12", 300), ("ü", 7)])
def test_fold_in_static_equals_flax(path):
    key = prng.PRNGKey(4)
    np.testing.assert_array_equal(
        prng.fold_in_static(key, path),
        np.asarray(_fold_in_static(jax.random.PRNGKey(4), path)))
    np.testing.assert_array_equal(prng.fold_in_static(key, ()), key)


def test_erf_log1p_and_erf_inv_equal_xla():
    x = np.linspace(-5, 5, 200_001).astype(np.float32)
    np.testing.assert_array_equal(prng.erf(x),
                                  np.asarray(jax.jit(jax.lax.erf)(x)))
    x = np.linspace(-0.9999, 10, 200_001).astype(np.float32)
    np.testing.assert_array_equal(prng.log1p(x),
                                  np.asarray(jax.jit(jnp.log1p)(x)))
    x = np.linspace(-1, 1, 200_001).astype(np.float32)
    np.testing.assert_array_equal(prng.erf_inv(x),
                                  np.asarray(jax.jit(jax.lax.erf_inv)(x)))


@pytest.mark.parametrize("seed", [0, 5])
def test_truncated_normal_is_bit_equal_to_jax(seed):
    """Stated tolerance: at most 2 ulp with a bit-equal share of at least
    the measured 100%, i.e. equal."""
    shape = (500_000,)
    got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape)
    want = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(seed), -2.0, 2.0, shape))
    assert _ulps(got, want) <= 2
    assert np.mean(got == want) >= 1.0
    assert got.min() > -2.0 and got.max() < 2.0


@pytest.mark.parametrize("shape", [(9, 64), (3, 3, 64, 128), (27, 16, 32),
                                   (1024, 512), (1, 1, 384, 14)])
def test_initializers_are_bit_equal_to_jax(shape):
    key, jkey = prng.PRNGKey(3), jax.random.PRNGKey(3)
    init = jax.nn.initializers
    for mine, theirs in (
            (prng.lecun_normal(), init.lecun_normal()),
            (prng.variance_scaling(2.0, "fan_in", "truncated_normal"),
             init.variance_scaling(2.0, "fan_in", "truncated_normal")),
            (prng.zeros, init.zeros), (prng.ones, init.ones),
            (prng.constant(-4.595), init.constant(-4.595))):
        got = mine(key, shape)
        want = np.asarray(theirs(jkey, shape, jnp.float32))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_the_draw_calls_no_numpy_transcendental(monkeypatch):
    """The f32 draw uses only operations whose result is the same on
    every host: numpy's own log1p, exp and friends dispatch by CPU."""
    want = prng.lecun_normal()(prng.PRNGKey(1), (64, 32))

    def refuse(*args, **kwargs):
        raise AssertionError("a host-dependent numpy function was called")
    for name in ("log1p", "log", "log2", "exp", "expm1", "exp2", "sin",
                 "cos", "tanh", "power", "float_power"):
        monkeypatch.setattr(np, name, refuse)
    got = prng.lecun_normal()(prng.PRNGKey(1), (64, 32))
    np.testing.assert_array_equal(got, want)
    prng.truncated_normal(prng.PRNGKey(2), -2.0, 2.0, (1000,))


# -- the threefry kernel's plain version ------------------------------------

@pytest.mark.parametrize("shape,offset", [
    ((16, 64, 128), 0),          # part seg's mask at a small batch
    ((24, 512), 0), ((24, 256), 0),   # the classifiers' head masks
    ((7, 13), 0),                # an odd count
    ((3, 5), 2 ** 32 - 7),       # the flat index crosses 2**32
    ((2, 9), 4 * 9)])            # a rank's row slice
def test_mask_plain_version_equals_jax_bernoulli(shape, offset):
    key = prng.fold_in(prng.PRNGKey(17 + 3), 4)
    got = threefry.bernoulli_mask(key, 0.6, shape, offset=offset,
                                  device="cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    want = prng.bernoulli(key, 0.6, shape, offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)
    if offset == 0:
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax.random.bernoulli(jnp.asarray(key), 0.6, shape)))
    if offset == 4 * 9:            # rows 4, 5 of an (8, 9) global mask
        whole = jax.random.bernoulli(jnp.asarray(key), 0.6, (8, 9))
        np.testing.assert_array_equal(got.numpy(), np.asarray(whole)[4:6])


def test_mask_refuses_a_bad_key_and_device():
    with pytest.raises(ValueError):
        threefry.bernoulli_mask(np.array([1, 2, 3], np.uint32), 0.6, (4,),
                                device="cpu")
    with pytest.raises(ValueError):
        threefry.bernoulli_mask(prng.PRNGKey(0), 0.6, (4,), device="meta")
