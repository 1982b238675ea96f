#!/usr/bin/env python3
"""Time the port's full-width train steps of the point networks on one
card: part segmentation (``configs/pointnet2_partseg_fixture_conv.yaml``,
batch 16), PointNet++ classification (``configs/pointnet2_modelnet40.yaml``
on the fixture, batch 24) and PointNet (``configs/pointnet_cls_fixture_conv
.yaml``, batch 32), dropout on, as ``train(cfg)`` takes them.

    python3 train_step_ms.py [--tree DIR] [--steps N]

``--tree`` names the checkout whose ``lisec_tpu_torch`` is timed (this
one by default), so that two commits are compared in one call on one
card: parent, change, change, parent. Each step is ``Pipeline.train_step``
on the next batch of the config's shuffled, augmented stream, between
CUDA events, after 3 warm-up steps; the median, mean and least ms of
``--steps`` steps are printed as one JSON line with the card's name and
power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CONFIGS = (
    ("pointnet2_partseg_fixture_conv", []),
    ("pointnet2_modelnet40", ["data.fixture=true", "data.fixture_size=512"]),
    ("pointnet_cls_fixture_conv", []),
)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_step_ms: no CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import lisec_tpu_torch
    from lisec_tpu_torch.config import apply_overrides
    from lisec_tpu_torch.data.collate import make_batches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    out = {"tree": tree, "card": card, "steps": args.steps, "ms": {}}
    for name, overrides in CONFIGS:
        cfg = apply_overrides(lisec_tpu_torch.load_config(
            os.path.join(tree, "configs", f"{name}.yaml")),
            [*overrides, 'train.ckpt_dir=""'])
        pipe = lisec_tpu_torch.build_model(cfg)
        pipe.init_state(cfg.train.seed)
        batches = make_batches(pipe.make_dataset("train"), cfg.budget,
                               cfg.train.batch_size, shuffle=True,
                               seed=cfg.train.seed,
                               augment_fn=pipe.augment_fn("train"))
        steps = [next(batches) for _ in range(args.steps + 3)]
        with torch.enable_grad():
            for b in steps[:3]:
                pipe.train_step(b)
            torch.cuda.synchronize()
            times = []
            for b in steps[3:]:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                pipe.train_step(b)
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
        times.sort()
        out["ms"][name] = {"median": times[len(times) // 2],
                           "mean": sum(times) / len(times),
                           "min": times[0], "batch": cfg.train.batch_size}
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
