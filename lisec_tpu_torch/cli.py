"""Command-line interface (port of ``lisec_tpu/cli.py``).

    python -m lisec_tpu_torch.cli train <config> [key=value ...]
    python -m lisec_tpu_torch.cli eval  <config> [key=value ...]
    python -m lisec_tpu_torch.cli infer <config> --cloud path [--ckpt dir]

Every verb runs on the card. ``train`` also runs data-parallel under
``torchrun`` (one process a card, NCCL; gloo for ``device="cpu"``),
with ``train.num_devices`` 0 or the number of ranks:

    torchrun --nproc_per_node 4 -m lisec_tpu_torch.cli train <config>

``infer`` and ``eval`` run on one process. ``infer`` restores the
latest checkpoint of ``--ckpt`` (else of ``train.ckpt_dir``) before it
predicts and prints the first cloud's outputs as JSON. The port is
measured by ``python3 portbench/run.py --workload <cell>``, not here.
"""

from __future__ import annotations

import argparse
import json

from lisec_tpu_torch.config import apply_overrides, load_config


def main(argv=None, device="cuda"):
    """Run one verb; ``device`` exists for the tests, which run on the
    CPU. ``infer`` also returns its outputs (tensors on ``device``),
    ``eval`` its metrics."""
    parser = argparse.ArgumentParser(prog="lisec-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    for name in ("train", "eval"):
        p = sub.add_parser(name)
        p.add_argument("config")
        p.add_argument("overrides", nargs="*")

    p = sub.add_parser("infer")
    p.add_argument("config")
    p.add_argument("--cloud", required=True)
    p.add_argument("--ckpt", default="")
    p.add_argument("overrides", nargs="*")

    args = parser.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), list(args.overrides))

    if args.command == "train":
        import torch.distributed as dist
        from lisec_tpu_torch.api import train
        from lisec_tpu_torch.parallel.mesh import initialize_distributed
        started = initialize_distributed(device=device)   # torchrun's
        try:
            train(cfg, device=device)
        finally:
            if started:
                dist.destroy_process_group()
    elif args.command == "eval":
        from lisec_tpu_torch.api import evaluate
        return evaluate(cfg, device=device)
    elif args.command == "infer":
        from lisec_tpu_torch.api import (
            build_model, infer, load_cloud, preprocess)
        from lisec_tpu_torch.training.checkpoint import CheckpointManager
        cloud = load_cloud(args.cloud)   # fail fast on bad input paths
        pipeline = build_model(cfg, device=device)
        pipeline.init_state(cfg.train.seed)
        ckpt_dir = args.ckpt or cfg.train.ckpt_dir
        if ckpt_dir:
            CheckpointManager(ckpt_dir).restore(pipeline)
        batch = {k: v[None] for k, v in preprocess(cloud, cfg).items()}
        out = infer(pipeline, batch, device=device)
        print(json.dumps(
            {k: v[0].cpu().tolist() for k, v in out.items()
             if k != "logits"}, indent=2))
        return out


if __name__ == "__main__":
    main()
