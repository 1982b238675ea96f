"""Print the first train step's loss of a config as the JAX package and
the port compute it on the CPU, from the same seed and batch:

    JAX_PLATFORMS=cpu python -m tests.step1_loss_cpu <config>

Both draw their initial weights from ``train.seed`` (the same draw, bit
for bit), take the first batch of the config's shuffled, augmented
stream (the same batch) and the JAX loop's key of step 0, and evaluate
the train-mode loss with its terms, as the first record of a training
run's ``metrics.jsonl`` holds it; then the loss of both on the same
clouds in three other orders of the batch (equal in exact arithmetic:
their spread is what the order of f32 sums does to a bf16 step); then
the port's loss with its BatchNorms' batch statistics summed in f64,
and with each batch mean of x and of x^2 moved by a relative error drawn
from N(0, (3e-5)^2) (seeds 0-5), the size of the errors of the JAX
program's f32 batch means (up to 3.9e-5 of the mean in
``tests/step1_layers_cpu.py``). For the full-width PointPillars config this takes
about four minutes."""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lisec_tpu
import lisec_tpu_torch
import lisec_tpu_torch.models.common as common
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches
from lisec_tpu_torch.parallel.mesh import global_mean


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
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed + 17), 0)
    jax_loss = jax.jit(lambda p, b: pipe.loss(
        p, state.batch_stats, b, rng, train=True))
    loss, (aux, _) = jax_loss(state.params, jax.tree.map(jnp.asarray, batch))
    out = {"config": config,
           "jax_cpu": {"loss": float(loss),
                       **{k: float(v) for k, v in aux.items()}}}
    port = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(config),
                                       device="cpu")
    port.init_state(port.cfg.train.seed)
    port.model.train()
    with torch.no_grad():
        loss, aux = port.loss(port.device_batch(batch), port.step_key(0))
    out["port_cpu"] = {"loss": float(loss),
                       **{k: float(v) for k, v in aux.items()}}
    out["other_orders"] = []
    for order in ([3, 2, 1, 0], [1, 0, 3, 2], [2, 3, 0, 1]):
        other = {k: np.asarray(v)[order] for k, v in batch.items()}
        with torch.no_grad():
            port_loss, _ = port.loss(port.device_batch(other),
                                     port.step_key(0))
        out["other_orders"].append({
            "order": order,
            "jax_cpu": float(jax_loss(state.params, jax.tree.map(
                jnp.asarray, other))[0]),
            "port_cpu": float(port_loss)})
    start = {k: v.clone() for k, v in port.model.state_dict().items()}
    exact_mean = global_mean

    def port_loss(stat_mean):
        common.global_mean = stat_mean
        try:
            port.model.load_state_dict(start)
            with torch.no_grad():
                return float(port.loss(port.device_batch(batch),
                                       port.step_key(0))[0])
        finally:
            common.global_mean = exact_mean
    out["port_cpu_f64_statistics"] = port_loss(
        lambda xs, dims: [x.double().mean(dim=dims).float() for x in xs])
    out["port_cpu_noisy_statistics"] = []
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        out["port_cpu_noisy_statistics"].append(port_loss(
            lambda xs, dims, gen=gen: [
                m * (1 + 3e-5 * torch.randn(m.shape, generator=gen))
                for m in exact_mean(xs, dims)]))
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
