"""``dryrun_multichip(n)`` (port of ``__graft_entry__.dryrun_multichip``):
one data-parallel train step of a shrunken PointPillars on ``n`` local
ranks (gloo, on the card), at a global batch of ``2 n``.

    python -c "from lisec_tpu_torch.parallel.dryrun import \
        dryrun_multichip; dryrun_multichip(4)"

``dryrun_multichip(4, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import math
import os

from lisec_tpu_torch.parallel.mesh import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The JAX entry's compile-check size: one conv a backbone block, the
# same op graph.
TINY_OVERRIDES = (
    "data.fixture_size=8",
    "train.ckpt_dir=",
    "budget.max_points=2048",
    "budget.max_voxels=256",
    "budget.max_points_per_voxel=8",
    "budget.nms_pre=128",
    "budget.nms_post=16",
    "model.params.pfn_filters=16",
    "model.params.backbone_layers=[1,1,1]",
    "model.params.backbone_filters=[16,32,64]",
    "model.params.backbone_up_filters=[32,32,32]",
)


def tiny_cfg(batch_size: int, num_devices: int = 1):
    from lisec_tpu_torch.config import apply_overrides, load_config
    cfg = load_config(os.path.join(ROOT, "configs", "pointpillars_tiny.yaml"))
    return apply_overrides(cfg, [f"train.batch_size={batch_size}",
                                 f"train.num_devices={num_devices}",
                                 *TINY_OVERRIDES])


def _rank_step(n: int, device: str) -> float:
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches
    cfg = tiny_cfg(2 * n, n)
    pipeline = build_model(cfg, device=device)
    pipeline.init_state(0)
    batch = next(make_batches(pipeline.make_dataset("train"), cfg.budget,
                              cfg.train.batch_size, shuffle=False))
    return float(pipeline.train_step(batch)["loss"])


def dryrun_multichip(n: int, device="cuda") -> float:
    """One DP train step on ``n`` ranks on the card (``run_ranks``; the
    CPU's plain kernels when the caller asks for ``device="cpu"``; without
    a card ``cuda`` raises); prints and returns the global loss, which
    every rank must agree on."""
    losses = run_ranks(_rank_step, n, n, str(device), device=device)
    loss = losses[0]
    if not math.isfinite(loss) or any(v != loss for v in losses):
        raise AssertionError(f"dryrun_multichip({n}): rank losses {losses}")
    print(f"dryrun_multichip({n}): ok, loss={loss:.4f}, ranks={n}")
    return loss
