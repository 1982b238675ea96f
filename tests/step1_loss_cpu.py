"""Print the first train step's loss of a config as the JAX package and
the port compute it on the CPU, from the same seed and batch:

    JAX_PLATFORMS=cpu python -m tests.step1_loss_cpu <config>

Both draw their initial weights from ``train.seed`` (the same draw, bit
for bit), take the first batch of the config's shuffled, augmented
stream (the same batch) and the JAX loop's key of step 0, and evaluate
the train-mode loss with its terms, as the first record of a training
run's ``metrics.jsonl`` holds it. For the full-width PointPillars config
this takes about a minute."""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.data.collate import make_batches as jax_make_batches


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
    loss, (aux, _) = jax.jit(lambda p, b: pipe.loss(
        p, state.batch_stats, b, rng, train=True))(
            state.params, jax.tree.map(jnp.asarray, batch))
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
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
