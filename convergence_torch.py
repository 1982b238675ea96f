"""Train one fixture config to convergence with the port and record it.

    python3 convergence_torch.py <name> <config> [--out DIR]
        [--ckpt-dir DIR] [--save-weights PATH] [--device cuda|cpu]
        [--init-weights NPZ] [--recall-by-difficulty
        [--reference-weights NPZ]] [key=value ...]

Runs ``lisec_tpu_torch.cli train <config> train.ckpt_dir=<ckpt-dir>`` and
then ``cli eval`` of the same config (the latest checkpoint), in this
process, and writes under ``--out`` (default ``docs/convergence_torch``):

* ``<name>_metrics.jsonl``: the run's ``metrics.jsonl``, the curve;
* ``<name>_eval.json``: the held-out metrics of ``cli eval``, the wall
  time of training and of evaluation, ms a step (the whole loop's mean,
  host feed and checkpoints included, from the last logged cumulative
  clouds/s), the card's name and power limit as ``nvidia-smi`` reports
  them, and any overrides beyond ``train.ckpt_dir``.

For the ModelNet40 fixture (40 classes, classes ``c`` and ``c + 20``
drawn from one shape distribution) it adds ``alias_pair_accuracy``:
the share of held-out clouds whose predicted class is the true one or
its alias. ``--recall-by-difficulty`` adds a detector's recall split by
the gt boxes' difficulty, and ``--reference-weights`` the same split for
a snapshot npz (the JAX package's, say) through the same evaluator.
``--init-weights`` starts the run from a snapshot in place of the
seed's draw (``python -m tests.make_jax_init_weights`` writes the JAX
package's initial weights). ``--save-weights`` writes the trained model with
``bench_lib.save_weights_npz`` (a file the JAX package's
``load_weights_npz`` reads). Overrides after the config are for trying
the script on small configs; a convergence run sets none.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time


def card_info() -> dict:
    """The card's name and power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else None}


def alias_pair_accuracy(cfg, device: str) -> dict:
    """Top-1 and alias-pair accuracy of the latest checkpoint over the
    ``test`` split of the 40-class fixture."""
    import numpy as np
    pipeline = restored(cfg, device)
    half = cfg.data.num_classes // 2
    hits = alias = n = 0
    for batch, out in pipeline.eval_outputs("test"):
        pred, label = out["labels"], np.asarray(batch["label"])
        hits += int((pred == label).sum())
        alias += int((pred % half == label % half).sum())
        n += len(label)
    return {"top1": hits / n, "alias_pair_accuracy": alias / n,
            "alias_n": n}


def restored(cfg, device: str, weights: str = ""):
    """A pipeline of ``cfg`` with the latest checkpoint's weights, or
    with ``weights`` (a snapshot npz) where given."""
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.training.checkpoint import CheckpointManager
    from lisec_tpu_torch.weights import load_weights_npz
    pipeline = build_model(cfg, device=device)
    pipeline.init_state(cfg.train.seed)
    if weights:
        load_weights_npz(pipeline.model, weights)
    else:
        CheckpointManager(cfg.train.ckpt_dir).restore(pipeline)
    return pipeline


def start_from(weights: str) -> None:
    """Make every pipeline's ``init_state`` load ``weights`` after its
    seed's draw (the optimizer is made on the same parameters, whose
    values the load replaces in place); a checkpoint's restore still
    comes after."""
    from lisec_tpu_torch.pipelines.base import Pipeline
    from lisec_tpu_torch.weights import load_weights_npz
    drawn = Pipeline.init_state

    def init_state(self, seed: int = 0) -> None:
        drawn(self, seed)
        load_weights_npz(self.model, weights)
    Pipeline.init_state = init_state


def recall_by_difficulty(pipeline) -> dict:
    """The evaluation's recall@0.5 over the ``val`` split, split by the
    gt boxes' difficulty (-1: near-invisible, which the hard fixture
    keeps out of the training targets and KITTI AP ignores): the same
    greedy matching as ``eval.detection.match_frame``, each gt counted
    under its own difficulty."""
    import numpy as np
    from lisec_tpu_torch.eval.detection import rotated_iou_bev_np
    from lisec_tpu_torch.eval.kitti_ap import collect_detections
    dets, gts = collect_detections(pipeline, split="val")
    total, hit = {}, {}
    for det, gt in zip(dets, gts):
        got = np.zeros(len(gt["boxes"]), bool)
        for db, dl in zip(det["boxes"], det["labels"]):
            for gi, (gb, gc) in enumerate(zip(gt["boxes"], gt["classes"])):
                if not got[gi] and gc == dl \
                        and rotated_iou_bev_np(db, gb) >= 0.5:
                    got[gi] = True
                    break
        for d, ok in zip(gt["difficulty"].tolist(), got.tolist()):
            total[d] = total.get(d, 0) + 1
            hit[d] = hit.get(d, 0) + ok
    return {f"difficulty_{d}": {"gts": total[d], "recall@0.5":
                                hit[d] / total[d]} for d in sorted(total)}


def save_weights(cfg, device: str, path: str) -> int:
    from lisec_tpu_torch.bench_lib import save_weights_npz
    pipeline = restored(cfg, device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_weights_npz(pipeline.model, path)
    return os.path.getsize(path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name")
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--out", default="docs/convergence_torch")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-weights", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--recall-by-difficulty", action="store_true",
                    help="detectors: also the recall split by the gt "
                    "boxes' difficulty")
    ap.add_argument("--init-weights", default="",
                    help="start from this snapshot npz (the JAX package's "
                    "initial weights, say) instead of the seed's draw")
    ap.add_argument("--reference-weights", default="",
                    help="with --recall-by-difficulty: the same split for "
                    "this snapshot npz, on the same split and evaluator")
    args = ap.parse_args(argv)

    from lisec_tpu_torch import cli
    from lisec_tpu_torch.config import apply_overrides, load_config

    ckpt_dir = args.ckpt_dir or os.path.join("runs", "convergence_torch",
                                             args.name)
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)     # a run starts from its seed
    argv_cfg = [args.config, f"train.ckpt_dir={ckpt_dir}", *args.overrides]
    cfg = apply_overrides(load_config(args.config), argv_cfg[1:])

    if args.init_weights:
        start_from(args.init_weights)
    t0 = time.time()
    cli.main(["train", *argv_cfg], device=args.device)
    train_s = time.time() - t0
    t0 = time.time()
    metrics = cli.main(["eval", *argv_cfg], device=args.device)
    eval_s = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    curve = os.path.join(args.out, f"{args.name}_metrics.jsonl")
    shutil.copyfile(os.path.join(ckpt_dir, "metrics.jsonl"), curve)
    with open(curve) as f:
        last = [json.loads(line) for line in f if line.strip()][-1]
    record = {
        "config": args.config,
        "overrides": list(args.overrides),
        "init_weights": args.init_weights or None,
        "steps": cfg.train.num_steps,
        "batch_size": cfg.train.batch_size,
        **{k: float(v) for k, v in metrics.items()},
        "train_wall_s": train_s,
        "eval_wall_s": eval_s,
        "ms_per_step": 1000.0 * cfg.train.batch_size
        / last["clouds_per_sec"],
        "final_loss": last["loss"],
        **card_info(),
        "torch": __import__("torch").__version__,
    }
    if cfg.model.name == "pointnet_cls" and cfg.data.fixture \
            and cfg.data.num_classes == 40:
        record.update(alias_pair_accuracy(cfg, args.device))
    if args.save_weights:
        record["weights_bytes"] = save_weights(cfg, args.device,
                                               args.save_weights)
        record["weights"] = args.save_weights
    if args.recall_by_difficulty:
        record["recall_by_difficulty"] = recall_by_difficulty(
            restored(cfg, args.device))
        if args.reference_weights:
            record["reference_weights"] = args.reference_weights
            record["reference_recall_by_difficulty"] = recall_by_difficulty(
                restored(cfg, args.device, args.reference_weights))
    path = os.path.join(args.out, f"{args.name}_eval.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
