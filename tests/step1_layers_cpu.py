"""Hold the port's bf16 PointPillars conv blocks against the JAX
package's on the CPU, one block at a time, on the first train step of a
config:

    JAX_PLATFORMS=cpu python -m tests.step1_layers_cpu [config]

(default ``configs/pointpillars_fixture_hard_conv.yaml``; about three
minutes). Both packages draw the same initial weights and take the same
first batch (``tests/step1_loss_cpu.py``). The JAX model runs once in
train mode with its intermediates captured; then each of the port's conv
blocks takes the JAX block's input (its input as the JAX program computed
it) in train mode, and for each block one JSON line gives the share of
its bf16 outputs that differ from the JAX block's (``port_vs_jax``) and,
for the plain convs, from the block as flax specifies it computed in f64
up to the final rounding (``port_vs_exact``, ``jax_vs_exact``), and the
largest relative error of the JAX program's batch mean against the f64
one, over the channels whose mean is at least a tenth of their standard
deviation."""

from __future__ import annotations

import copy
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu_torch.models.common import pad_same


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def main(config: str) -> None:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = jax_load_config(config)
    pipe = lisec_tpu.build_model(cfg)
    state = pipe.init_state(cfg.train.seed)
    batch = next(jax_make_batches(
        pipe.make_dataset("train"), cfg.budget, cfg.train.batch_size,
        shuffle=True, seed=cfg.train.seed,
        augment_fn=pipe.augment_fn("train")))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    _, mutated = jax.jit(lambda v, p, m: pipe.model.apply(
        v, p, m, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(
            variables, jnp.asarray(batch["points"]),
            jnp.asarray(batch["point_mask"]))
    inter = mutated["intermediates"]
    blocks = inter["BEVBackbone_0"]
    new_stats = mutated["batch_stats"]["BEVBackbone_0"]

    port = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(config),
                                       device="cpu")
    port.init_state(port.cfg.train.seed)
    layers = port.model.backbone.layers
    # Each block's input: the canvas, or the block before it (the neck's
    # upsampling blocks take the last block of their stage).
    sources, prev, i = [], "canvas", 0
    for n in port.model.backbone.layer_nums:
        for j in range(n + 1):
            sources.append(prev)
            prev = i
            i += 1
        sources.append(prev)                  # the stage's upsampling
        i += 1
    canvas = _f32(inter["FusedPillarEncoder_0"]["__call__"][0])
    for i, layer in enumerate(layers):
        src = sources[i]
        x = canvas if src == "canvas" else _f32(
            blocks[f"ConvBNRelu_{src}"]["__call__"][0])
        want = _f32(blocks[f"ConvBNRelu_{i}"]["__call__"][0])
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        block = copy.deepcopy(layer).train()
        with torch.no_grad():
            got = block(xt.to(block.dtype)).float().numpy()
        line = {"block": i, "input": src, "transpose": layer.transpose,
                "outputs": int(want.size),
                "port_vs_jax": float(np.mean(
                    got.transpose(0, 2, 3, 1) != want))}
        if not layer.transpose:
            w = layer.weight.detach().bfloat16().double()
            c = F.conv2d(pad_same(xt.double(), layer.kernel, layer.stride),
                         w, stride=layer.stride)
            mean = c.mean((0, 2, 3))
            var = c.var((0, 2, 3), unbiased=False)
            mul = torch.rsqrt(var + 1e-3) * layer.scale.detach().double()
            exact = torch.relu(((c - mean.view(1, -1, 1, 1))
                                * mul.view(1, -1, 1, 1)
                                + layer.bias.detach().double().view(
                                    1, -1, 1, 1)).float().bfloat16()
                               ).float().numpy().transpose(0, 2, 3, 1)
            # The running mean starts at 0: the step wrote 0.01 * mean.
            jax_mean = np.asarray(new_stats[f"ConvBNRelu_{i}"][
                "BatchNorm_0"]["mean"], np.float64) / 0.01
            big = (mean.abs() >= 0.1 * var.sqrt()).numpy()
            rel = np.abs(jax_mean - mean.numpy()) / np.abs(mean.numpy())
            line.update(
                port_vs_exact=float(np.mean(
                    got.transpose(0, 2, 3, 1) != exact)),
                jax_vs_exact=float(np.mean(want != exact)),
                jax_mean_rel_err=float(rel[big].max()) if big.any()
                else None)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else "configs/pointpillars_fixture_hard_conv.yaml")
