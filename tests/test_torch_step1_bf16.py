"""Where the port's bf16 train step on the CPU and the JAX package's part.

``configs/pointpillars_fixture_hard_conv.yaml`` computes in bf16. Its
first-step loss on the CPU (``python -m tests.step1_loss_cpu``) differs
between the two packages by more than 1e-4, from the same weights, batch
and key. Two things make it:

* Where the conv's result is rounded. XLA's CPU backend runs a bf16
  convolution in f32 on the bf16 values and, since it allows excess
  precision, drops the f32 -> bf16 -> f32 casts between the conv and the
  BatchNorm that reads it: flax's BatchNorm gets the unrounded f32 sums.
  A PyTorch bf16 conv rounds them to bf16, and on a bf16 BatchNorm input
  that moved 13-19% of each ConvBNRelu's outputs by a bf16 step. The
  anchor head's bias (its class prior) is added after the rounding, in
  bf16. The port now computes both as XLA's CPU program does
  (``models/common.py::cpu_excess_precision``, ``AnchorHead``).
* The BatchNorm's batch statistics, f32 sums over every row of the
  batch. XLA's CPU reductions sum long runs in order and part from the
  exact mean by up to 3.9e-5 of it at the full model's sizes, which
  moves up to 1.3% of a block's bf16 outputs by a step; torch's sums
  leave the port's blocks within 1e-4 of the exactly rounded ones
  (``python -m tests.step1_layers_cpu``). The steps compound through
  the 19 conv blocks: the reference's own step-1 loss moves by more
  than 1e-4 when only the order of the clouds in its batch changes, and
  errors of that size put into the port's statistics raise its loss
  onto the reference's (``python -m tests.step1_loss_cpu``). That is a
  recorded difference, not a fault.

Inputs are made from seeds; both packages run on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu.models.common import ConvBNRelu as JaxConvBNRelu
from lisec_tpu.models.pointpillars import AnchorHead as JaxAnchorHead
from lisec_tpu_torch.models.common import (
    ConvBNRelu, batch_norm, conv_transpose_same, pad_same)
from lisec_tpu_torch.models.pointpillars import AnchorHead

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
BF16 = ["model.params.dtype=bfloat16"]

# (kernel, stride, transposed): the backbone's convs and the neck's
# upsampling.
CONVS = [(3, 1, False), (3, 2, False), (2, 2, True)]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _conv_bn_relu_pair(kernel, stride, transpose, seed=0,
                       shape=(4, 48, 40, 64)):
    """A flax ``ConvBNRelu(dtype=bfloat16)`` with running statistics, the
    port's with the same weights, and a post-ReLU-like NHWC input."""
    rng = np.random.default_rng(seed)
    x = _bf16(np.maximum(rng.normal(0.3, 1.0, shape), 0).astype(np.float32))
    c = shape[-1]
    jmodel = JaxConvBNRelu(c, kernel=kernel, stride=stride,
                           transpose=transpose, dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.asarray(x, jnp.bfloat16))["params"]
    stats = {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(0, 0.5, c), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32)}}
    kern = np.asarray(params["ConvTranspose_0" if transpose
                             else "Conv_0"]["kernel"])
    port = ConvBNRelu(c, c, kernel, stride, transpose=transpose,
                      dtype=torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            kern[::-1, ::-1].transpose(2, 3, 0, 1) if transpose
            else kern.transpose(3, 2, 0, 1))))
        for name in ("mean", "var"):
            getattr(port, name).copy_(torch.from_numpy(
                np.array(stats["BatchNorm_0"][name])))
    variables = {"params": params, "batch_stats": stats}
    return jmodel, variables, port, x


def _jax_out(jmodel, variables, x, train):
    fn = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=train, mutable=["batch_stats"])[0])
    out = fn(variables, jnp.asarray(x, jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32)).transpose(0, 3, 1, 2)


def _exact(port, x, train):
    """The layer as flax specifies it, in f64 up to the final rounding:
    the conv of the bf16 values, the batch statistics (train) or the
    running ones, the normalisation, one rounding to bf16, the ReLU."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w = port.weight.detach().bfloat16().double()
    if port.transpose:
        c = conv_transpose_same(xt.double(), w, port.stride)
    else:
        c = F.conv2d(pad_same(xt.double(), port.kernel, port.stride), w,
                     stride=port.stride)
    if train:
        mean, var = c.mean((0, 2, 3)), c.var((0, 2, 3), unbiased=False)
    else:
        mean, var = port.mean.double(), port.var.double()
    mul = torch.rsqrt(var + 1e-3) * port.scale.detach().double()
    y = (c - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
        + port.bias.detach().double().view(1, -1, 1, 1)
    return torch.relu(y.float().bfloat16()).float().numpy()


@pytest.mark.parametrize("kernel,stride,transpose", CONVS)
def test_conv_bn_relu_rounds_where_xla_cpu_does(kernel, stride, transpose):
    """With the running statistics (no reduction in play), the port's
    bf16 ConvBNRelu on the CPU equals the JAX package's in all but a
    share of outputs that only the f32 order of the conv's sums moves
    (measured up to 4.1e-5, held to 2e-4). Rounding the conv's result to
    bf16 first, as the port did before and as cuDNN does on the card,
    moves 13-14% of them."""
    jmodel, variables, port, x = _conv_bn_relu_pair(kernel, stride,
                                                    transpose)
    want = _jax_out(jmodel, variables, x, train=False)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    port.eval()
    with torch.no_grad():
        got = port(xt).float().numpy()
        w = port.weight.bfloat16()
        if transpose:
            conv = conv_transpose_same(xt.bfloat16(), w, stride)
        else:
            conv = F.conv2d(pad_same(xt.bfloat16(), kernel, stride), w,
                            stride=stride)
        rounded_first = torch.relu(batch_norm(
            conv.float(), port, 1).bfloat16()).float().numpy()
    assert got.shape == want.shape
    assert np.mean(got != want) <= 2e-4
    assert np.mean(rounded_first != want) > 0.1


def test_batch_statistics_are_where_the_cpu_programs_part():
    """In train mode the port's ConvBNRelu is the layer as flax specifies
    it, computed exactly up to the final rounding (``_exact``), in all but
    2e-4 of its outputs (measured 5.7e-5), as it is with the running
    statistics. The JAX package's parts from the exact layer more often
    with its batch statistics than with the running ones (measured 1.3e-4
    against 2.6e-5 at this size, and 1.2% of the outputs of the full
    model's second conv block): its f32 sums of the statistics are what
    moves."""
    shares = {}
    for train in (False, True):
        jmodel, variables, port, x = _conv_bn_relu_pair(3, 1, False)
        port.train(train)
        with torch.no_grad():
            got = port(torch.from_numpy(np.ascontiguousarray(
                x.transpose(0, 3, 1, 2)))).float().numpy()
        exact = _exact(port, x, train)
        want = _jax_out(jmodel, variables, x, train)
        shares[train] = (np.mean(got != exact), np.mean(want != exact))
    assert shares[False][0] <= 2e-4 and shares[True][0] <= 2e-4
    assert shares[True][1] > 3 * shares[False][1], shares


def test_second_dense_conv_rounds_where_xla_cpu_does(monkeypatch):
    """SECOND's dense tail (a bf16 3x3x3 conv, its masked BatchNorm over
    the active cells, ReLU, the mask) follows the same rule: with the
    running statistics the port equals the JAX package's in all but 2e-4
    of the outputs (measured 3.0e-5), where rounding the conv's result to
    bf16 first moves 2.7% of them."""
    from flax import linen as nn
    from lisec_tpu.models.second import MaskedBatchNorm
    import lisec_tpu_torch.models.second as second

    class Tail(nn.Module):
        @nn.compact
        def __call__(self, x, mask):
            h = nn.Conv(32, (3, 3, 3), padding=((1, 1),) * 3,
                        use_bias=False, dtype=jnp.bfloat16)(x)
            h = nn.relu(MaskedBatchNorm()(h, mask, False))
            return h * mask.astype(h.dtype)
    rng = np.random.default_rng(3)
    mask = (rng.random((2, 6, 20, 22, 1)) < 0.6).astype(np.float32)
    x = _bf16(np.maximum(rng.normal(0.3, 1, (2, 6, 20, 22, 32)), 0)
              .astype(np.float32)) * mask
    jx, jm = jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16)
    tail = Tail()
    v = tail.init(jax.random.PRNGKey(3), jx, jm)
    v = {"params": v["params"], "batch_stats": {"MaskedBatchNorm_0": {
        "mean": jnp.asarray(rng.normal(0, 0.5, 32), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 2, 32), jnp.float32)}}}
    want = np.asarray(jax.jit(tail.apply)(v, jx, jm).astype(jnp.float32))
    port = second.DenseConv3D(32, 32, 1, torch.bfloat16).eval()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.asarray(v["params"]["Conv_0"]["kernel"]).transpose(
                4, 3, 0, 1, 2))))
        for name in ("mean", "var"):
            getattr(port, name).copy_(torch.from_numpy(np.array(
                v["batch_stats"]["MaskedBatchNorm_0"][name])))
    xt = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 4, 1, 2, 3))).bfloat16()
    mt = torch.from_numpy(np.ascontiguousarray(
        mask.transpose(0, 4, 1, 2, 3))).bfloat16()
    with torch.no_grad():
        got = port(xt, mt).float().numpy().transpose(0, 2, 3, 4, 1)
        monkeypatch.setattr(second, "cpu_excess_precision", lambda t: t)
        first = port(xt, mt).float().numpy().transpose(0, 2, 3, 4, 1)
    assert np.mean(got != want) <= 2e-4
    assert np.mean(first != want) > 0.02


def test_anchor_head_adds_its_bias_after_rounding():
    """flax's bf16 ``Conv`` adds the bias to the rounded conv in bf16; the
    port's head on the CPU does the same, so the class logits, whose bias
    is the focal prior, equal the JAX package's (measured equal on every
    output, held to 1e-3 of them)."""
    rng = np.random.default_rng(2)
    x = _bf16(np.abs(rng.normal(size=(2, 31, 27, 96))).astype(np.float32))
    jhead = JaxAnchorHead(1, 2, dtype=jnp.bfloat16)
    v = jhead.init(jax.random.PRNGKey(2), jnp.asarray(x, jnp.bfloat16))
    want = jax.jit(jhead.apply)(v, jnp.asarray(x, jnp.bfloat16))
    port = AnchorHead(96, 1, 2, dtype=torch.bfloat16)
    with torch.no_grad():
        for i, conv in enumerate((port.cls, port.box, port.dir)):
            p = v["params"][f"Conv_{i}"]
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["kernel"])[0, 0].T))[:, :, None, None])
            conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        got = port(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))))
    assert float(np.asarray(v["params"]["Conv_0"]["bias"])[0]) == \
        pytest.approx(-4.595)
    for k in ("cls", "box", "dir"):
        assert np.mean(got[k].numpy() != np.asarray(want[k])) <= 1e-3, k


def test_step1_loss_within_the_reference_spread_over_batch_orders():
    """``pointpillars_tiny`` in bf16: the first train step's loss of both
    packages from the same weights and batch, and the JAX package's on
    the same clouds in three other orders, equal in exact arithmetic. The
    reference's own loss moves by more than 1e-4 between orders (measured
    1.3e-3), and the port's lies within that spread of it (measured
    4.5e-4)."""
    jcfg = jax_apply_overrides(jax_load_config(TINY), BF16)
    jax_pipe = lisec_tpu.build_model(jcfg)
    state = jax_pipe.init_state(jcfg.train.seed)
    batch = next(jax_make_batches(
        jax_pipe.make_dataset("train"), jcfg.budget, jcfg.train.batch_size,
        shuffle=True, seed=jcfg.train.seed))
    rng = jax.random.fold_in(jax.random.PRNGKey(jcfg.train.seed + 17), 0)
    loss = jax.jit(lambda p, b: jax_pipe.loss(p, state.batch_stats, b, rng,
                                              train=True)[0])
    orders = [[0, 1, 2, 3], [3, 2, 1, 0], [1, 0, 3, 2], [2, 3, 0, 1]]
    jax_losses = [float(loss(state.params, {
        k: jnp.asarray(np.asarray(v)[o]) for k, v in batch.items()}))
        for o in orders]

    port = lisec_tpu_torch.build_model(lisec_tpu_torch.apply_overrides(
        lisec_tpu_torch.load_config(TINY), BF16), device="cpu")
    port.init_state(port.cfg.train.seed)
    assert port.model.head.dtype == torch.bfloat16
    port.model.train()
    with torch.no_grad():
        got, _ = port.loss(port.device_batch(batch), port.step_key(0))
    port.model.eval()

    spread = max(jax_losses) - min(jax_losses)
    assert spread > 1e-4 * jax_losses[0]
    assert abs(float(got) - jax_losses[0]) <= spread
