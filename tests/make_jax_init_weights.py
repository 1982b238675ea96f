"""Write the JAX package's initial weights of a config, as its training
loop draws them (``pipeline.init_state(train.seed)``), to a flat npz that
the port's ``load_weights_npz`` reads:

    JAX_PLATFORMS=cpu python -m tests.make_jax_init_weights <config> <out.npz>

The parameters' shapes and draws do not depend on the input's, so the
init runs on a one-cloud batch of 256 points over a 5.12 m square (a
32 x 32 grid for PointPillars) to stay small on the CPU. With
``convergence_torch.py --init-weights`` it lets a port run start from
the reference's weights."""

from __future__ import annotations

import sys

from lisec_tpu.api import build_model
from lisec_tpu.bench_lib import save_weights_npz
from lisec_tpu.config import apply_overrides, load_config

SMALL = ["train.batch_size=1", "budget.max_points=256",
         "voxel.point_cloud_range=[0.0,-2.56,-3.0,5.12,2.56,1.0]"]


def main(config: str, out: str) -> None:
    cfg = apply_overrides(load_config(config), SMALL)
    pipeline = build_model(cfg)
    save_weights_npz(pipeline.init_state(cfg.train.seed), out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
