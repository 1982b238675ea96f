#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lisec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it goes wrong:

1. build every CUDA kernel of the main paths from
   ``lisec_tpu_torch/csrc`` with nvcc for sm_90a, all at once;
2. hold each kernel against its plain PyTorch version on the card, at
   the main paths' shapes plus edge cases: the fused encoder on random
   clouds at KITTI geometry; ``segment_paint`` in its three channel
   splits, ``segment_unpaint``, and ``segment_max_sorted`` forward and
   backward (f32 inputs, and bf16-valued inputs full of ties);
   ``spread_accumulate`` on the rulebooks of ray-cast scenes at SECOND's
   full width and on edge cases, bit for bit, and the sparse conv's
   ``Function`` forward and backward;
3. drive the inference path: full-width PointPillars inference
   (``configs/pointpillars_kitti.yaml``, bf16) with the trained snapshot
   ``weights/pointpillars_fixture_hard.npz`` on 8 ray-cast scenes, with
   the launch counts set to 0 just before and read just after; check the
   outputs, and that the kernel path and the plain encoder agree; check
   the small ``pointpillars_tiny`` predict on the card against the CPU;
4. drive the training path: full-width PointPillars train steps
   (``configs/pointpillars_fixture_hard_conv.yaml``, bf16, batch 4,
   adamw + onecycle + clip) from the same snapshot on ray-cast scenes,
   the launch counts again set to 0 just before and read just after;
   check the loss, gradients, parameters and running statistics; take
   the first step's loss and gradients again with the paint and unpaint
   wrappers swapped for their plain versions; then a short
   ``lisec_tpu_torch.train(cfg)`` from seed initialisation;
5. drive SECOND serving (``configs/second_kitti.yaml`` at full width,
   bf16, seed-initialised weights, 8 ray-cast scenes) through
   ``build_model`` and ``infer`` with the launch counts set to 0 just
   before and read just after, and hold the kernel route against the
   plain route; drive SECOND training
   (``configs/second_fixture_conv.yaml`` at full width, batch 4) the same
   way as phase 4;
6. time the PointPillars predict at batch 8 and 32, the SECOND predict
   at batch 1 and 8 with its stages, both train steps and their parts at
   batch 4, and every kernel, its plain version, its glue and (where one
   exists) the PyTorch call for the same function at the main paths'
   shapes, with CUDA events;
7. print the ``{"kernels": [...]}`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the rest of the repository; without either it
exits nonzero before printing any result.
"""

import json
import contextlib
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_CFG = os.path.join(ROOT, "configs", "pointpillars_kitti.yaml")
TINY_CFG = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
SECOND_TINY_CFG = os.path.join(ROOT, "configs", "second_tiny.yaml")
TRAIN_CFG = os.path.join(ROOT, "configs",
                         "pointpillars_fixture_hard_conv.yaml")
WEIGHTS = os.path.join(ROOT, "weights", "pointpillars_fixture_hard.npz")
SECOND_CFG = os.path.join(ROOT, "configs", "second_kitti.yaml")
SECOND_TRAIN_CFG = os.path.join(ROOT, "configs", "second_fixture_conv.yaml")
KERNEL_SOURCES = ("encoder_kernel", "segment_paint", "segment_unpaint",
                  "spread_accumulate")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def emit(tag: str, **fields) -> None:
    print(json.dumps({"card": CARD, "phase": tag, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- phase 1 ----------------------------------------------------------------

def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from lisec_tpu_torch.ops.cuda import build
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(build.build, KERNEL_SOURCES))
    for name, res in zip(KERNEL_SOURCES, results):
        ptxas = [ln.strip() for ln in res["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds=res["seconds"], ptxas=ptxas)


# -- phase 2 ----------------------------------------------------------------

def kitti_geometry():
    from lisec_tpu_torch.config import load_config
    cfg = load_config(KITTI_CFG)
    nx, ny, _ = cfg.voxel.grid_size
    return dict(grid=(nx, ny), voxel_size=tuple(cfg.voxel.voxel_size[:2]),
                pc_range=tuple(cfg.voxel.point_cloud_range))


def edge_case_clouds(b, n, geo, gen):
    """Random clouds over (a bit more than) the range, with cloud 1 all in
    one cell, cloud 2 all masked and cloud 3 exactly on cell edges."""
    import torch
    r, (vx, vy) = geo["pc_range"], geo["voxel_size"]
    lo = torch.tensor([r[0] - 2, r[1] - 2, r[2] - 1, 0.0])
    hi = torch.tensor([r[3] + 2, r[4] + 2, r[5] + 1, 1.0])
    pts = lo + (hi - lo) * torch.rand((b, n, 4), generator=gen)
    mask = torch.rand((b, n), generator=gen) > 0.1
    pts[1, :, 0] = r[0] + 100.5 * vx + 0.01 * torch.rand(n, generator=gen)
    pts[1, :, 1] = r[1] + 200.5 * vy + 0.01 * torch.rand(n, generator=gen)
    mask[1] = True
    mask[2] = False
    nx, ny = geo["grid"]
    ix = torch.randint(0, nx + 1, (n,), generator=gen).float()
    iy = torch.randint(0, ny + 1, (n,), generator=gen).float()
    pts[3, :, 0] = ix * vx + r[0]
    pts[3, :, 1] = iy * vy + r[1]
    return pts, mask


def check_canvas(got, ref, dtype, what):
    """f32: same non-empty pattern, |d| <= 1e-4 max(1, |ref|);
    bf16: within one bf16 ulp of the f32 plain value."""
    import torch
    got = got.float()
    if dtype == torch.float32:
        if not torch.equal(got != 0, ref != 0):
            raise AssertionError(f"{what}: non-empty pattern differs")
        tol = 1e-4 * ref.abs().clamp_min(1.0)
    else:
        _, e = torch.frexp(ref)
        tol = torch.ldexp(torch.ones_like(ref), e - 8)   # one bf16 ulp
    bad = (got - ref).abs() > tol
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, max |d| "
            f"{float((got - ref).abs().max())}")
    return float((got - ref).abs().max())


def phase_kernel_check(gen):
    import torch
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    geo = kitti_geometry()
    b, n, c = 4, 32768, 64
    pts, mask = edge_case_clouds(b, n, geo, gen)
    w = 0.2 * torch.randn((9, c), generator=gen)
    t = 0.1 * torch.randn((c,), generator=gen)
    pts, mask, w, t = (a.cuda() for a in (pts, mask, w, t))
    ref = ek.pillar_canvas_fused_reference(
        pts, mask, w, t, out_dtype=torch.float32, **geo)
    for dtype in (torch.float32, torch.bfloat16):
        got = ek.pillar_canvas_fused(pts, mask, w, t, out_dtype=dtype, **geo)
        torch.cuda.synchronize()
        err = check_canvas(got, ref, dtype, f"pillar_canvas_fused {dtype}")
        emit("kernel_check", kernel="pillar_canvas_fused",
             dtype=str(dtype), shape=list(got.shape), max_abs_err=err,
             nonempty_cells=int((ref != 0).any(-1).sum()))


# The three channel splits the train path paints with, at its full-width
# shapes: (rows per cloud, channels, max channels, table rows).
NCELLS = 432 * 496
PAINT_SPLITS = {
    "stats": dict(n=32768, c=4, num_max=0, num_cells=NCELLS),
    "segmax": dict(n=32768, c=65, num_max=64, num_cells=NCELLS),
    "assigner": dict(n=131072, c=3, num_max=2, num_cells=NCELLS // 2),
}


def edge_case_ids(n, num_cells, gen):
    """(4, N) int32 ascending ids: cloud 0 random over the table with an
    invalid tail (some ids negative), cloud 1 all rows in the last cell,
    cloud 2 all rows invalid (an empty table), cloud 3 a dense block of
    cells with long segments plus the last cell."""
    import torch
    ids = torch.empty((4, n), dtype=torch.int64)
    ids[0] = torch.randint(-50, num_cells + num_cells // 8, (n,),
                           generator=gen)
    ids[1] = num_cells - 1
    ids[2] = num_cells + torch.randint(0, 9, (n,), generator=gen)
    ids[3] = torch.randint(1000, 1400, (n,), generator=gen)
    ids[3, :7] = num_cells - 1
    return torch.sort(ids, dim=1).values.to(torch.int32)


def check_paint(got, ref, num_max, what):
    """Max channels bit-equal. Sum channels: kernel and plain version
    both add in f64 and round to f32 once, the kernel in row order, the
    plain version's ``index_add_`` in the order its atomics land, so they
    may differ by the last f32 bit where the f64 sums straddle a rounding
    point: |d| <= 2^-22 |ref| + 1e-8. Returns (max |d|, elements whose
    bits differ)."""
    import torch
    if not torch.equal(got[..., :num_max], ref[..., :num_max]):
        raise AssertionError(f"{what}: max channels differ")
    d = (got[..., num_max:] - ref[..., num_max:]).abs()
    if d.numel() == 0:
        return 0.0, 0
    tol = 2.0 ** -22 * ref[..., num_max:].abs() + 1e-8
    if (d > tol).any():
        raise AssertionError(f"{what}: {int((d > tol).sum())} sums off, "
                             f"max |d| {float(d.max())}")
    return float(d.max()), int((d != 0).sum())


def phase_segment_kernel_check(gen):
    """segment_paint, segment_unpaint and segment_max_sorted on the card
    against their plain versions, at the train path's shapes and on edge
    cases. Returns the largest |difference| seen for each kernel."""
    import torch
    from lisec_tpu_torch.ops import scatter
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    worst = {"segment_paint": 0.0, "segment_unpaint": 0.0}

    for split, sh in PAINT_SPLITS.items():
        n, c, num_max, nc = sh["n"], sh["c"], sh["num_max"], sh["num_cells"]
        cases = {"full_width": (edge_case_ids(n, nc, gen), nc)}
        # Every cell of a small table occupied (more rows than cells).
        small = torch.sort(torch.randint(0, 1000, (4, 8192), generator=gen),
                           dim=1).values.to(torch.int32)
        small[:, :1000] = torch.arange(1000, dtype=torch.int32)
        cases["every_cell_occupied"] = (torch.sort(small, 1).values, 1000)
        for case, (ids, cells) in cases.items():
            vals = torch.randn(ids.shape + (c,), generator=gen)
            vals[..., c - 1] = 1.0                   # the callers' ones
            vals, ids = vals.cuda(), ids.cuda()
            got = sp.segment_paint(vals, ids, num_cells=cells,
                                   num_max=num_max)
            torch.cuda.synchronize()
            ref = sp.segment_paint_reference(vals, ids, num_cells=cells,
                                             num_max=num_max)
            err, bits = check_paint(got, ref, num_max,
                                    f"segment_paint {split} {case}")
            again = sp.segment_paint(vals, ids, num_cells=cells,
                                     num_max=num_max)
            if not torch.equal(got, again):
                raise AssertionError(f"segment_paint {split} {case}: two "
                                     "runs differ")
            # In two parts (as the segment max asks for its canvas and
            # count): the same bits, each part dense.
            head, tail = sp.segment_paint(vals, ids, num_cells=cells,
                                          num_max=num_max, split=c - 1)
            if not (torch.equal(head, got[..., :c - 1])
                    and torch.equal(tail, got[..., c - 1:])
                    and head.is_contiguous() and tail.is_contiguous()):
                raise AssertionError(f"segment_paint {split} {case}: the "
                                     "two-part table differs")
            occupied = got[..., c - 1] > 0
            if case == "every_cell_occupied" and not occupied.all():
                raise AssertionError("every_cell_occupied: empty cells")
            if case == "full_width" and (
                    occupied[2].any() or int(occupied[1].sum()) != 1
                    or not occupied[1, cells - 1]
                    or not occupied[3, cells - 1]):
                raise AssertionError(f"segment_paint {split}: edge clouds")
            worst["segment_paint"] = max(worst["segment_paint"], err)
            emit("kernel_check", kernel="segment_paint", split=split,
                 case=case, shape=list(got.shape), num_max=num_max,
                 max_channels="bit-equal", sum_max_abs_err=err,
                 sum_elements_differing=bits,
                 occupied_cells=int(occupied.sum()))

    # segment_unpaint: the train path's tables (C = 64 and 4, the vector
    # path) and a C that is no multiple of 4 (the scalar path); bit-equal,
    # the zero rows of invalid ids included.
    ids = edge_case_ids(32768, NCELLS, gen).cuda()
    for c in (64, 4, 65):
        table = torch.randn((4, NCELLS, c), generator=gen).cuda()
        got = su.segment_unpaint(table, ids)
        torch.cuda.synchronize()
        ref = su.segment_unpaint_reference(table, ids)
        if not torch.equal(got, ref):
            raise AssertionError(f"segment_unpaint C={c}: "
                                 f"{int((got != ref).sum())} elements differ")
        if got[2].any() or not got[1].any():
            raise AssertionError("segment_unpaint: edge clouds")
        emit("kernel_check", kernel="segment_unpaint",
             table=list(table.shape), shape=list(got.shape),
             max_abs_err=0.0, bit_equal=True)

    # segment_max_sorted: the kernel Function against the same Function
    # over the plain versions, value and gradient, bit-equal.
    ids = edge_case_ids(32768, NCELLS, gen).cuda()
    for name, h in (
            ("f32", torch.randn((4, 32768, 64), generator=gen)),
            ("bf16_ties", (torch.randint(0, 6, (4, 32768, 64), generator=gen)
                           * 0.25).bfloat16())):
        g = torch.randn((4, NCELLS, 64), generator=gen).cuda()
        outs = []
        for plain in (False, True):
            hh = h.cuda().requires_grad_()
            with torch.enable_grad(), (plain_segment_ops() if plain
                                       else contextlib.nullcontext()):
                canvas, count = scatter.segment_max_sorted(hh, ids, NCELLS)
                (canvas * g).sum().backward()
            torch.cuda.synchronize()
            outs.append((canvas.detach(), count, hh.grad))
        for what, a, b in zip(("canvas", "count", "grad"), *outs):
            if not torch.equal(a, b):
                raise AssertionError(f"segment_max_sorted {name}: {what} "
                                     "differs from the plain Function")
        grad = outs[0][2].float()
        # Rows that got a cotangent per (cell, channel) with one: ties
        # take the whole cotangent each, so this exceeds 1 with ties.
        takers = float((grad != 0).sum()) / max(
            float(((outs[0][1] > 0)[..., None] & (g != 0)).sum()), 1.0)
        emit("kernel_check", kernel="segment_max_sorted", inputs=name,
             forward="bit-equal", backward="bit-equal",
             rows_with_gradient_per_cell_channel=takers)
    return worst


@contextlib.contextmanager
def swapped_segment_ops(paint, unpaint, spread):
    """Swap ``segment_paint``, ``segment_unpaint`` and
    ``spread_accumulate`` in the modules that call them, here only: the
    package has no switch on the card."""
    from lisec_tpu_torch.models import pillar_encoder
    from lisec_tpu_torch.ops import scatter, sparse_conv, voxelize
    from lisec_tpu_torch.training import assigner
    new = {"segment_paint": paint, "segment_unpaint": unpaint,
           "spread_accumulate": spread}
    saved = [(mod, name, getattr(mod, name))
             for mod in (pillar_encoder, scatter, assigner, voxelize,
                         sparse_conv)
             for name in new if hasattr(mod, name)]
    for mod, name, _ in saved:
        setattr(mod, name, new[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_segment_ops():
    """The callers on the kernels' plain PyTorch versions."""
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    return swapped_segment_ops(sp.segment_paint_reference,
                               su.segment_unpaint_reference,
                               sa.spread_accumulate_reference)


# -- phase 3 ----------------------------------------------------------------

def scene_batch(cfg, b, seed0=0):
    """``b`` ray-cast scenes (seeds seed0...), padded to the budgets."""
    import numpy as np
    from lisec_tpu_torch.api import preprocess
    from lisec_tpu_torch.data.fixtures import make_detection_scene_hard
    scenes = [make_detection_scene_hard(
        seed0 + i, pc_range=tuple(cfg.voxel.point_cloud_range))
        for i in range(b)]
    clouds = [preprocess(sc["points"], cfg) for sc in scenes]
    batch = {k: np.stack([c[k] for c in clouds])
             for k in ("points", "point_mask")}
    return batch, [sc["gt_boxes"] for sc in scenes]


def recall_at_half(out, gts):
    """Share of gt boxes with a kept box of BEV IoU >= 0.5."""
    import torch
    from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev
    hit = total = 0
    for i, gt in enumerate(gts):
        det = out["boxes"][i][out["valid"][i]]
        gt = torch.as_tensor(gt, device=det.device)
        total += len(gt)
        if len(det) and len(gt):
            iou = rotated_iou_bev(gt[:, None, :], det[None, :, :])
            hit += int((iou.max(dim=1).values >= 0.5).sum())
    return hit / max(total, 1)


def same_outputs(a, b, what, atol):
    import torch
    for k in ("valid", "labels"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differ")
    for k in ("boxes", "scores"):
        d = float((a[k] - b[k]).abs().max())
        if d > atol:
            raise AssertionError(f"{what}: {k} differ by {d} > {atol}")


def phase_main_path(pipe, cfg):
    """The main path: full-width predict with the trained snapshot, its
    launch counts, output checks and the plain-encoder comparison."""
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    batch, gts = scene_batch(cfg, 8)
    ek.LAUNCHES = 0
    out = infer(pipe, batch)
    torch.cuda.synchronize()
    launches = ek.LAUNCHES
    if launches < 1:
        raise AssertionError("the main path never launched "
                             "pillar_canvas_fused")
    for k in ("boxes", "scores"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"predict: non-finite {k}")
    if out["boxes"].shape != (8, cfg.budget.nms_post, 7):
        raise AssertionError(f"predict: boxes {tuple(out['boxes'].shape)}")
    if not out["valid"].any():
        raise AssertionError("predict: no box kept in 8 scenes")

    # The same predict with the encoder swapped for the kernel's plain
    # version, here only: the package has no switch to it on the card.
    enc = pipe.model.encoder
    w, t = enc.folded_weights()
    geo = dict(grid=enc.grid, voxel_size=enc.voxel_size,
               pc_range=enc.pc_range)
    enc.forward = lambda p, m: ek.pillar_canvas_fused_reference(
        p.float().contiguous(), m, w, t, out_dtype=enc.dtype, **geo)
    plain = infer(pipe, batch)
    del enc.forward
    same_outputs(out, plain, "kernel vs plain encoder predict", 1e-3)

    # The kernel against its plain version on the main path's inputs.
    pts = torch.as_tensor(batch["points"], device="cuda")
    mask = torch.as_tensor(batch["point_mask"], device="cuda")
    got = ek.pillar_canvas_fused(pts, mask, w, t, out_dtype=enc.dtype, **geo)
    ref = ek.pillar_canvas_fused_reference(pts, mask, w, t,
                                           out_dtype=torch.float32, **geo)
    check_canvas(got, ref, enc.dtype, "main-path canvas")
    plain_canvas = ek.pillar_canvas_fused_reference(
        pts, mask, w, t, out_dtype=enc.dtype, **geo)
    err = float((got.float() - plain_canvas.float()).abs().max())
    emit("main_path", config="pointpillars_kitti", batch=8,
         launches={"pillar_canvas_fused": launches},
         kept_per_cloud=out["valid"].sum(1).tolist(),
         recall_at_iou_half=recall_at_half(out, gts), max_abs_err=err)
    return launches, err


def phase_tiny_vs_cpu(name, cfg_path, keep_sets):
    """A small config on the card against the same on the CPU (the CPU
    path is the one the tests hold against the JAX package): the head
    maps to 1e-4 and, with ``keep_sets``, the predict's outputs. (The
    seed-initialised second_tiny scores lie closer together than the two
    devices' f32 sums differ, so the order of its candidates, and with it
    the keep set, is not determined.)"""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    from lisec_tpu_torch.config import apply_overrides
    # Score threshold 0: the random weights' scores sit near the head's
    # prior, and every candidate then goes through NMS.
    cfg = apply_overrides(load_config(cfg_path),
                          ["model.params.score_threshold=0.0"])
    batch, _ = scene_batch(cfg, 4)
    outs, maps = [], []
    for d in ("cuda", "cpu"):
        pipe = build_model(cfg, d)
        outs.append({k: v.cpu() for k, v in infer(pipe, batch, d).items()})
        with torch.no_grad():
            maps.append({k: v.cpu() for k, v in pipe.model(
                *pipe._model_args(pipe.device_batch(batch))).items()})
    diffs = {k: float((maps[0][k] - maps[1][k]).abs().max()) for k in maps[0]}
    if max(diffs.values()) > 1e-4:
        raise AssertionError(f"{name} cuda vs cpu head maps: {diffs}")
    if keep_sets:
        same_outputs(outs[0], outs[1], f"{name} cuda vs cpu", 1e-4)
    emit("tiny_vs_cpu", config=name, head_map_max_abs_diff=diffs,
         keep_sets_compared=keep_sets,
         kept_per_cloud=outs[0]["valid"].sum(1).tolist())


# -- phase 4: the training path ---------------------------------------------

TRAIN_STEPS = 3


def train_config(path, num_steps, log_every=1):
    """A full-width training config; the overrides are no widths."""
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(path), [
        "data.augment.enabled=false", 'train.ckpt_dir=""',
        f"train.num_steps={num_steps}", f"train.log_every={log_every}"])


def segment_launches():
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    return {"segment_paint": sp.LAUNCHES, "segment_unpaint": su.LAUNCHES,
            "spread_accumulate": sa.LAUNCHES}


def zero_segment_launches():
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    sp.LAUNCHES = su.LAUNCHES = sa.LAUNCHES = 0


def loss_and_grads(pipe, batch):
    import torch
    pipe.model.train()
    pipe.optimizer.zero_grad()
    with torch.enable_grad():
        loss, aux = pipe.loss(pipe.device_batch(batch))
        loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), aux["num_pos"].detach(),
            {n: p.grad.clone() for n, p in pipe.model.named_parameters()})


def phase_train_path(name, cfg_path, weights, per_step):
    """Full-width train steps of config ``name`` through ``train_step``
    (from the snapshot ``weights``, or from seed initialisation), their
    launch counts (``per_step`` of each kernel) and checks; the first
    step's loss and gradients again over the kernels' plain versions;
    then a short ``lisec_tpu_torch.train`` from seed initialisation whose
    loss falls."""
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.weights import load_weights_npz
    cfg = train_config(cfg_path, TRAIN_STEPS)
    pipe = build_model(cfg)
    pipe.init_state(cfg.train.seed)
    if weights:
        load_weights_npz(pipe.model, weights)
    batches = make_batches(pipe.make_dataset("train"), cfg.budget,
                           cfg.train.batch_size, shuffle=True,
                           seed=cfg.train.seed)
    first = next(batches)
    start = {k: v.clone() for k, v in pipe.model.state_dict().items()}

    zero_segment_launches()
    with torch.enable_grad():
        auxes = [pipe.train_step(first if i == 0 else next(batches))
                 for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = segment_launches()
    if launches != {k: v * TRAIN_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"{name}: train path launches {launches} in "
                             f"{TRAIN_STEPS} steps, expected {per_step} "
                             "a step")
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    for a in auxes:
        if not all(v == v and abs(v) != float("inf") for v in a.values()):
            raise AssertionError(f"train step: non-finite {a}")
        if a["num_pos"] <= 0:
            raise AssertionError("train step: no positive anchor")
    stuck = []
    for k, v in pipe.model.state_dict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"train step: non-finite {k}")
        if torch.equal(v, start[k]):
            stuck.append(k)
    if stuck:
        raise AssertionError(f"train step: unchanged after "
                             f"{TRAIN_STEPS} steps: {stuck}")
    if pipe.step != TRAIN_STEPS:
        raise AssertionError(f"optimizer count {pipe.step}")
    emit("train_path", config=name,
         batch=cfg.train.batch_size, steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         per_step=auxes, tensors_moved=len(start))

    # The first step's loss and gradients, kernels against plain
    # versions. cuDNN is held to deterministic algorithms so that the
    # two runs differ by the kernels alone; those are exact (max, gather,
    # the spread's ordered f32 sum) or equal to the last f32 bit (f64
    # sums), so: loss within
    # 1e-5 relative, every gradient within 1e-3 of its own L2 norm.
    torch.backends.cudnn.deterministic = True
    pipe.model.load_state_dict(start)
    loss_k, pos_k, grads_k = loss_and_grads(pipe, first)
    pipe.model.load_state_dict(start)
    before = segment_launches()
    with plain_segment_ops():
        loss_p, pos_p, grads_p = loss_and_grads(pipe, first)
    if segment_launches() != before:
        raise AssertionError("the plain run launched a kernel")
    torch.backends.cudnn.deterministic = False
    if float(pos_k) != float(pos_p):
        raise AssertionError(f"num_pos {float(pos_k)} vs {float(pos_p)}")
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if rel_loss > 1e-5:
        raise AssertionError(f"loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    worst, worst_name = 0.0, ""
    for pname, gk in grads_k.items():
        gp = grads_p[pname]
        rel = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, pname
    if worst > 1e-3:
        raise AssertionError(f"gradient of {worst_name}: relative L2 "
                             f"difference {worst} from the plain run")
    emit("train_vs_plain", config=name, loss=float(loss_k), plain_loss=float(loss_p),
         loss_rel_diff=rel_loss, num_pos=float(pos_k),
         worst_grad_rel_l2=worst, worst_grad=worst_name,
         gradients=len(grads_k))

    # The normal entry point, from seed initialisation.
    short = train_config(cfg_path, 8, log_every=2)
    with torch.enable_grad():
        trained, history = lisec_tpu_torch.train(short, progress=False)
    torch.cuda.synchronize()
    if len(history) != 5 or trained.step != 8:
        raise AssertionError(f"train(): {len(history)} records, "
                             f"step {trained.step}")
    for rec in history:
        if not all(v == v and abs(v) != float("inf")
                   for v in rec.values()):
            raise AssertionError(f"train(): non-finite {rec}")
    # Batches differ, so single steps jitter: the mean of the last two
    # logged losses against the first step's.
    if not (history[-1]["loss"] + history[-2]["loss"]) / 2 \
            < history[0]["loss"]:
        raise AssertionError(f"{name}: train() loss did not fall: "
                             f"{[r['loss'] for r in history]}")
    emit("train_entry_point", config=name, steps=8,
         loss_per_logged_step={r["step"]: r["loss"] for r in history},
         lr={r["step"]: r["lr"] for r in history})
    pipe.model.load_state_dict(start)
    return pipe, cfg, first, launches


def paint_bound(vals, ids, num_cells):
    """Least ms: every id and the rows this run's ids place in the table
    read once (a dropped row's values are never needed), the table written
    once, over the memory rate; one compare or add per placed row-channel
    over the f32 rate."""
    b, _, c = vals.shape
    placed = int(((ids >= 0) & (ids < num_cells)).sum())
    nbytes = ids.nbytes + placed * c * 4 + b * num_cells * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = placed * c / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def unpaint_bound(table, ids):
    """Least ms: the ids and the table rows this run's ids name read
    once, the output written once; no arithmetic."""
    import torch
    b, r, c = table.shape
    ok = (ids >= 0) & (ids < r)
    flat = ids.long() + torch.arange(b, device=ids.device)[:, None] * r
    rows_read = int(torch.unique(flat[ok]).numel())
    nbytes = ids.nbytes + rows_read * c * 4 + ids.numel() * c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def spread_bound(vals, targets, num_out):
    """Least ms: every id and the value rows this run's ids land in the
    table read once (a dropped row's values are never needed), the table
    written once, over the memory rate; one add per landed row-channel
    over the f32 rate."""
    b, _, _, c = vals.shape
    landed = int(((targets >= 0) & (targets < num_out)).sum())
    nbytes = (targets.nbytes + landed * c * vals.element_size()
              + b * num_out * c * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = landed * c / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, landed


def spread_call_row(vals, targets, num_out):
    """One ``spread_accumulate`` call timed on the tensors a path handed
    it: the kernel, its plain version, its bound, and ``index_add_`` as
    the one PyTorch call for the same function (f32 atomics in no fixed
    order; it takes f32 values, so a bf16 stream's conversion is timed
    with it)."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    b, k, n, c = vals.shape
    bound, by, nbytes, landed = spread_bound(vals, targets, num_out)
    rows = (torch.where((targets < 0) | (targets >= num_out), num_out,
                        targets).long()
            + torch.arange(b, device="cuda")[:, None, None] * (num_out + 1)
            ).reshape(-1)
    flat = vals.reshape(-1, c)
    return dict(
        vals=list(vals.shape), dtype=str(vals.dtype), num_out=num_out,
        rows_landed=landed, rows_total=b * k * n,
        ms=cuda_ms(lambda: sa.spread_accumulate(vals, targets,
                                                num_out=num_out), 20),
        plain_ms=cuda_ms(lambda: sa.spread_accumulate_reference(
            vals, targets, num_out=num_out), 3),
        library_ms=cuda_ms(lambda: torch.zeros(
            (b * (num_out + 1), c), device="cuda").index_add_(
                0, rows, flat.float()), 10),
        bound_ms=bound, bound_by=by, bytes=nbytes)


def phase_train_timing(name, pipe, cfg, batch):
    """The train step of config ``name`` and its parts at batch 4, and
    the kernels on the very tensors one train step hands them."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    b = cfg.train.batch_size
    with torch.enable_grad():
        ms_step = cuda_ms(lambda: pipe.train_step(batch), iters=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            pipe.train_step(batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3

        dev = pipe.device_batch(batch)
        parts = dict.fromkeys(("forward", "assign_loss", "backward",
                               "optimizer"), 0.0)
        for it in range(7):                          # 2 warm-up + 5
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            pipe.model.train()
            pipe.optimizer.zero_grad()
            ev[0].record()
            preds = pipe.model(*pipe._model_args(dev))
            ev[1].record()
            loss, _ = pipe.loss_terms(preds, pipe.assign(dev))
            ev[2].record()
            loss.backward()
            ev[3].record()
            pipe.optimizer.step()
            ev[4].record()
            torch.cuda.synchronize()
            if it >= 2:
                for i, k in enumerate(parts):
                    parts[k] += ev[i].elapsed_time(ev[i + 1]) / 5
    emit("train_step", config=name, batch=b,
         ms_per_step=ms_step, clouds_per_s=b * 1e3 / ms_step,
         host_clock_ms_per_step=host_ms,
         host_clock_clouds_per_s=b * 1e3 / host_ms,
         **{f"{k}_ms": v for k, v in parts.items()})

    # Record what one forward and backward hands the wrappers.
    calls = {"segment_paint": [], "segment_unpaint": [],
             "spread_accumulate": []}

    def rec_paint(vals, ids, *, num_cells, num_max, split=None):
        calls["segment_paint"].append((vals.detach(), ids, num_cells,
                                       num_max, split))
        return sp.segment_paint(vals, ids, num_cells=num_cells,
                                num_max=num_max, split=split)

    def rec_unpaint(table, ids):
        calls["segment_unpaint"].append((table.detach(), ids))
        return su.segment_unpaint(table, ids)

    def rec_spread(vals, targets, *, num_out):
        calls["spread_accumulate"].append((vals.detach(), targets, num_out))
        return sa.spread_accumulate(vals, targets, num_out=num_out)

    with swapped_segment_ops(rec_paint, rec_unpaint, rec_spread):
        loss_and_grads(pipe, batch)
    rows = {"spread_accumulate": [spread_call_row(*call) for call
                                  in calls["spread_accumulate"]]}

    per_call = []
    for vals, ids, nc, num_max, split in calls["segment_paint"]:
        c = vals.shape[2]
        offs = sp.segment_offsets(ids, nc)
        out = torch.empty((vals.shape[0], nc, split or c), device="cuda")
        tail = torch.empty((vals.shape[0], nc, c - split),
                           device="cuda") if split else None
        bound, by, nbytes = paint_bound(vals, ids, nc)
        library = None
        if num_max == 0:
            # One PyTorch call computes an all-sum table: index_add_ (on
            # a table with a trash row per cloud, f32 atomics).
            rows_ix = (torch.where((ids < 0) | (ids >= nc), nc, ids).long()
                       + torch.arange(vals.shape[0], device="cuda")[:, None]
                       * (nc + 1)).reshape(-1)
            flat = vals.reshape(-1, c)
            library = cuda_ms(lambda: torch.zeros(
                (vals.shape[0] * (nc + 1), c), device="cuda").index_add_(
                    0, rows_ix, flat), 20)
        per_call.append(dict(
            rows=list(vals.shape), table_rows=nc, num_max=num_max,
            split=split,
            rows_placed=int(((ids >= 0) & (ids < nc)).sum()),
            ms=cuda_ms(lambda: sp.segment_paint(
                vals, ids, num_cells=nc, num_max=num_max, split=split), 20),
            kernel_ms=cuda_ms(lambda: sp.launch_paint_kernel(
                vals, offs, out, num_max=num_max, out_tail=tail), 20),
            glue_ms=cuda_ms(lambda: sp.segment_offsets(ids, nc), 20),
            plain_ms=cuda_ms(lambda: sp.segment_paint_reference(
                vals, ids, num_cells=nc, num_max=num_max, split=split), 5),
            library_ms=library, bound_ms=bound, bound_by=by, bytes=nbytes))
    rows["segment_paint"] = per_call

    per_call = []
    for table, ids in calls["segment_unpaint"]:
        c = table.shape[2]
        bound, by, nbytes = unpaint_bound(table, ids)
        ok = (ids >= 0) & (ids < table.shape[1])
        idx = torch.where(ok, ids, 0).long()[..., None].expand(-1, -1, c)
        per_call.append(dict(
            table=list(table.shape), rows=list(ids.shape),
            ms=cuda_ms(lambda: su.segment_unpaint(table, ids), 20),
            plain_ms=cuda_ms(lambda: su.segment_unpaint_reference(
                table, ids), 5),
            library_ms=cuda_ms(lambda: torch.gather(table, 1, idx), 20),
            bound_ms=bound, bound_by=by, bytes=nbytes))
    rows["segment_unpaint"] = per_call
    for kernel, per_call in rows.items():
        for i, call in enumerate(per_call):
            emit("train_kernel", config=name, kernel=kernel, call=i, **call)
    return rows


# -- phase 5: inference timing ----------------------------------------------

def conv_flops(model, ny, nx):
    """Flops (2 per multiply-add) of the backbone, neck and head convs for
    one (ny, nx) canvas, from the layer shapes."""
    flops, h, w = 0, ny, nx
    layers = list(model.backbone.layers)
    i = 0
    head_hw = None
    for n in model.backbone.layer_nums:
        for layer in layers[i:i + n + 1]:
            h, w = -(-h // layer.stride), -(-w // layer.stride)
            flops += 2 * layer.weight.numel() * h * w
        # The up branch: a stride-1 conv, or a transposed conv with
        # kernel = stride whose every input pixel takes one weight pass.
        flops += 2 * layers[i + n + 1].weight.numel() * h * w
        head_hw = head_hw or h * w
        i += n + 2
    head = model.head
    for conv in (head.cls, head.box, head.dir):
        flops += 2 * conv.weight.numel() * head_hw
    return flops


def encoder_bound(pts, mask, w, t, out_elems, out_bytes, valid_points,
                  nonempty_cells):
    """Least time (ms) for the function: each input read once and the
    canvas written once over the memory rate, against its f32 operations
    (8 per point-channel, about 10 per non-empty cell-channel) over the
    f32 rate."""
    c = w.shape[1]
    nbytes = (pts.nbytes + mask.nbytes + w.nbytes + t.nbytes
              + out_elems * out_bytes)
    ops = 8 * c * valid_points + 10 * c * nonempty_cells
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def phase_timing(pipe, cfg):
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    enc = pipe.model.encoder
    nx, ny = enc.grid
    geo = dict(grid=enc.grid, voxel_size=enc.voxel_size,
               pc_range=enc.pc_range)
    w, t = enc.folded_weights()
    gflop = conv_flops(pipe.model, ny, nx) / 1e9
    emit("backbone_flops", gflop_per_cloud=gflop,
         floor_us_per_cloud_at_989_tflops=gflop / 989e3 * 1e6)
    rows = {}
    for b in (8, 32):
        batch, _ = scene_batch(cfg, b)
        n0 = ek.LAUNCHES
        ms = cuda_ms(lambda: infer(pipe, batch), iters=10)
        launches = (ek.LAUNCHES - n0) / 12           # 2 warm-up + 10 runs
        dev = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        with torch.no_grad():
            ms_dev = cuda_ms(lambda: pipe.predict(dev), iters=10)
            ms_model = cuda_ms(lambda: pipe.model(dev["points"],
                                                  dev["point_mask"]), 10)
            canvas = enc(dev["points"], dev["point_mask"])
            x = canvas.view(b, ny, nx, -1).permute(0, 3, 1, 2)
            ms_net = cuda_ms(lambda: pipe.model.head(pipe.model.backbone(x)),
                             10)
        pts, mask = dev["points"], dev["point_mask"]
        ms_enc = cuda_ms(lambda: ek.pillar_canvas_fused(
            pts, mask, w, t, out_dtype=enc.dtype, **geo), 20)
        ms_plain = cuda_ms(lambda: ek.pillar_canvas_fused_reference(
            pts, mask, w, t, out_dtype=enc.dtype, **geo), 5)
        ms_glue = cuda_ms(lambda: ek.sort_by_cell(pts, mask, **geo), 20)
        _, pts_s, offs = ek.sort_by_cell(pts, mask, **geo)
        out = torch.empty_like(canvas)
        ms_kernel = cuda_ms(lambda: ek.launch_canvas_kernel(
            pts_s, offs, w, t, out, nx=nx, voxel_size=enc.voxel_size,
            pc_range=enc.pc_range), 20)
        valid = int(ek.pillar_cells(pts, mask, **geo)[1].sum())
        nonempty = int((offs[:, 1:] > offs[:, :-1]).sum())
        bound, bound_by, nbytes = encoder_bound(
            pts, mask, w, t, canvas.numel(), canvas.element_size(), valid,
            nonempty)
        emit("predict", config="pointpillars_kitti", batch=b,
             ms_per_batch=ms, clouds_per_s=b * 1e3 / ms,
             device_resident_ms=ms_dev,
             device_resident_clouds_per_s=b * 1e3 / ms_dev,
             model_forward_ms=ms_model, backbone_head_ms=ms_net,
             decode_nms_ms=ms_dev - ms_model)
        # What the kernel alone moves: the cell-sorted points and the
        # offset table in, the canvas out (the function's bound above
        # counts the raw points and mask instead).
        kernel_bytes = (pts_s.nbytes + offs.nbytes + w.nbytes + t.nbytes
                        + out.nbytes)
        emit("encoder", batch=b, wrapper_ms=ms_enc, kernel_ms=ms_kernel,
             glue_ms=ms_glue, plain_ms=ms_plain, bound_ms=bound,
             launches_per_predict=launches,
             bound_by=bound_by, bytes=nbytes, valid_points=valid,
             nonempty_cells=nonempty, kernel_bytes=kernel_bytes,
             kernel_gb_per_s=kernel_bytes / ms_kernel / 1e6)
        rows[b] = dict(ms=ms_enc, plain_ms=ms_plain, bound_ms=bound,
                       bound_by=bound_by)
    return rows[8]


# -- SECOND: the spread kernel, serving, timing -------------------------------

def recorded_sparse_convs(pipe, dev):
    """One eval forward on a device batch with a hook on every sparse
    conv: [(layer, feats, out_of, valid)] in the encoder's order."""
    import torch
    seen = []
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args: seen.append((mod,) + tuple(args)))
        for layer in pipe.model.encoder.sparse]
    pipe.model.eval()
    with torch.no_grad():
        pipe.model(*pipe._model_args(dev))
    for h in hooks:
        h.remove()
    return seen


def phase_spread_kernel_check(pipe, cfg, gen):
    """``spread_accumulate`` on the card against its plain version, bit
    for bit and twice: on the scatter rulebooks of ray-cast scenes at
    SECOND's full width, on edge cases, and through the sparse conv's
    ``Function`` forward and backward. Returns the largest |difference|
    from the plain version that it saw."""
    import torch
    from lisec_tpu_torch.ops import sparse_conv
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    batch, _ = scene_batch(cfg, 4)
    convs = recorded_sparse_convs(pipe, pipe.device_batch(batch))
    if len(convs) != 9:
        raise AssertionError(f"{len(convs)} sparse convs recorded")
    gen = torch.Generator(device="cuda").manual_seed(gen.initial_seed())

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    worst = 0.0

    def check(what, vals, targets, num_out):
        nonlocal worst
        got = sa.spread_accumulate(vals, targets, num_out=num_out)
        torch.cuda.synchronize()
        ref = sa.spread_accumulate_reference(vals, targets, num_out=num_out)
        again = sa.spread_accumulate(vals, targets, num_out=num_out)
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"spread_accumulate {what}: {int((got != ref).sum())} "
                f"elements differ from the plain version, max |d| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"spread_accumulate {what}: two runs "
                                 "differ")
        landed = (targets >= 0) & (targets < num_out)
        idx = torch.where(landed, targets, num_out).long().flatten(1)
        hits = torch.zeros((vals.shape[0], num_out + 1), device="cuda")
        hits.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
        emit("kernel_check", kernel="spread_accumulate", case=what,
             vals=list(vals.shape), dtype=str(vals.dtype), num_out=num_out,
             rows_landed=int(landed.sum()), rows_total=targets.numel(),
             most_offsets_on_one_row=int(hits[:, :num_out].max()),
             output_rows_hit=int((hits[:, :num_out] > 0).sum()),
             bit_equal=True, two_runs_identical=True, max_abs_err=err)
        return got

    # Level-0 submanifold (N 16,000, C 16), level-2 submanifold (N 26,624,
    # C 64) and the strided conv into level 3 (26,624 -> 18,432 rows).
    for what, i in (("level0_subm", 0), ("level2_subm", 6),
                    ("level2_down", 8)):
        layer, _, out_of, valid = convs[i]
        b, k, n = out_of.shape
        c = layer.weight.shape[2]
        for dtype in (torch.bfloat16, torch.float32):
            check(what, randn((b, k, n, c), dtype), out_of, valid.shape[1])

    b, k, n, num_out = 2, 27, 4096, 4096
    ident = torch.arange(n, dtype=torch.int32).expand(b, k, n).contiguous()
    last = torch.full((b, k, n), -1, dtype=torch.int32)
    last[:, :, 17] = num_out - 1
    for what, targets, c in (
            ("all_rows_dropped", ident + num_out, 16),
            ("all_rows_dropped_negative", ident - n, 16),
            ("every_output_hit_by_all_offsets", ident, 64),
            ("all_streams_onto_the_last_row", last, 32),
            ("one_channel", ident.flip(2).contiguous(), 1),
            ("odd_channels", ident, 5)):
        for dtype in (torch.bfloat16, torch.float32):
            got = check(what, randn((b, k, n, c), dtype), targets.cuda(),
                        num_out)
            if "dropped" in what and got.any():
                raise AssertionError(f"{what}: a dropped row landed")
            if what == "all_streams_onto_the_last_row" and (
                    got[:, :-1].any() or not got[:, -1].any()):
                raise AssertionError(f"{what}: rows beside the last")

    # The conv's Function, kernels against plain versions: the same
    # products around them, so the forward must be bit-equal; the
    # backward's two products take the gathered rows, bit-equal too, and
    # are held to 1e-6 of their L2 norm.
    for i in (0, 8):
        layer, feats, out_of, valid = convs[i]
        g = randn((feats.shape[0], valid.shape[1], layer.weight.shape[2]),
                  torch.float32)
        outs = []
        for plain in (False, True):
            x = feats.to(layer.dtype).detach().clone().requires_grad_()
            w = layer.weight.detach().to(layer.dtype).requires_grad_()
            with torch.enable_grad(), (plain_segment_ops() if plain
                                       else contextlib.nullcontext()):
                y = sparse_conv.sparse_conv3d_spread(
                    x, out_of, w, v_out=valid.shape[1])
                (y * g).sum().backward()
            torch.cuda.synchronize()
            outs.append((y.detach(), x.grad.float(), w.grad.float()))
        if not torch.equal(outs[0][0], outs[1][0]):
            raise AssertionError(f"sparse conv {i}: forward differs from "
                                 "the plain Function")
        rel = [float((a - p).norm() / p.norm().clamp_min(1e-30))
               for a, p in zip(outs[0][1:], outs[1][1:])]
        if max(rel) > 1e-6:
            raise AssertionError(f"sparse conv {i}: gradients differ from "
                                 f"the plain Function by {rel}")
        emit("kernel_check", kernel="sparse_conv3d_spread", conv=i,
             features=list(feats.shape), out_rows=valid.shape[1],
             forward="bit-equal", grad_rel_l2=rel,
             backward_bit_equal=all(torch.equal(a, p) for a, p in
                                    zip(outs[0][1:], outs[1][1:])))
    return worst


SECOND_LAUNCHES_PER_PREDICT = {"segment_paint": 2, "segment_unpaint": 0,
                               "spread_accumulate": 9}
SECOND_LAUNCHES_PER_TRAIN_STEP = {"segment_paint": 3, "segment_unpaint": 10,
                                  "spread_accumulate": 9}
POINTPILLARS_LAUNCHES_PER_TRAIN_STEP = {
    "segment_paint": 3, "segment_unpaint": 3, "spread_accumulate": 0}


def phase_second_serving(pipe, cfg):
    """SECOND serving at full width through ``infer``: launch counts,
    output checks, per-level active counts, and the kernel route against
    the plain route (head maps; keep sets with the score threshold at 0
    so that NMS has work)."""
    import torch
    from lisec_tpu_torch.api import infer
    batch, _ = scene_batch(cfg, 8)
    zero_segment_launches()
    out = infer(pipe, batch)
    torch.cuda.synchronize()
    launches = segment_launches()
    if launches != SECOND_LAUNCHES_PER_PREDICT:
        raise AssertionError(f"second predict launches {launches}, "
                             f"expected {SECOND_LAUNCHES_PER_PREDICT}")
    for k in ("boxes", "scores"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"second predict: non-finite {k}")
    if out["boxes"].shape != (8, cfg.budget.nms_post, 7):
        raise AssertionError(f"second predict: boxes "
                             f"{tuple(out['boxes'].shape)}")

    dev = pipe.device_batch(batch)
    convs = recorded_sparse_convs(pipe, dev)
    enc = pipe.model.encoder
    # Level l's list is what its first conv takes; the last sparse conv's
    # output list is the first dense level's.
    counts = [(convs[3 * lv][2][:, 13] >= 0).sum(1).tolist()
              for lv in range(enc.dense_from)]
    counts.append(convs[-1][3].sum(1).tolist())

    def head_maps():
        with torch.no_grad():
            return pipe.model(*pipe._model_args(dev))
    maps_k = head_maps()
    threshold, pipe.score_thr = pipe.score_thr, 0.0
    out_k = infer(pipe, batch)
    before = segment_launches()
    with plain_segment_ops():
        maps_p = head_maps()
        out_p = infer(pipe, batch)
    if segment_launches() != before:
        raise AssertionError("the plain route launched a kernel")
    pipe.score_thr = threshold
    diffs = {k: float((maps_k[k] - maps_p[k]).abs().max()) for k in maps_k}
    if max(diffs.values()) > 1e-3:
        raise AssertionError(f"second head maps differ: {diffs}")
    if not out_k["valid"].any():
        raise AssertionError("second predict at threshold 0: no box kept")
    same_outputs(out_k, out_p, "second kernel vs plain route", 1e-3)
    emit("second_main_path", config="second_kitti", batch=8,
         launches=launches, voxels_and_active_per_level=counts,
         budgets=list(enc.level_budgets),
         kept_per_cloud=out["valid"].sum(1).tolist(),
         kept_per_cloud_at_threshold_0=out_k["valid"].sum(1).tolist(),
         head_map_max_abs_diff_vs_plain=diffs,
         head_maps_bit_equal=all(torch.equal(maps_k[k], maps_p[k])
                                 for k in maps_k))
    return launches


class EventTimer:
    """CUDA-event spans around wrapped callables, summed by name."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            self.spans.setdefault(name, []).append((start, stop))
            return out
        return timed

    def ms_per_run(self, runs):
        import torch
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in spans) / runs
                for name, spans in self.spans.items()}


def second_stage_ms(pipe, dev, runs=5):
    """Mean ms of a device-resident predict's stages, by events around
    the pipeline's own calls (wrapped here only)."""
    import torch
    from lisec_tpu_torch.models import second
    model = pipe.model
    timer = EventTimer()
    wrapped = [(pipe, "_model_args", "voxelize"), (model, "forward", "model"),
               (model.encoder, "forward", "encoder"),
               (model.backbone, "forward", "backbone_head"),
               (model.head, "forward", "backbone_head")]
    wrapped += [(m, "forward", "sparse_convs") for m in model.encoder.sparse]
    wrapped += [(m, "forward", "dense_tail") for m in model.encoder.dense]
    functions = {"build_scatter_rulebook": "rulebooks",
                 "build_output_coords": "rulebooks",
                 "build_footprint_coords": "rulebooks",
                 "segment_sum_dense": "densify"}
    saved = {f: getattr(second, f) for f in functions}

    def run():
        with torch.no_grad():
            pipe.predict(dev)
    run()
    run()
    try:
        for obj, attr, name in wrapped:
            setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))
        for f, name in functions.items():
            setattr(second, f, timer.wrap(name, saved[f]))
        total = cuda_ms(run, iters=runs, warmup=0)
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
        for f, fn in saved.items():
            setattr(second, f, fn)
    ms = timer.ms_per_run(runs)
    ms["decode_nms"] = total - ms["voxelize"] - ms["model"]
    ms["predict"] = total
    return ms


def phase_second_timing(pipe, cfg):
    """SECOND predict at batch 1 and 8 (from host numpy, device-resident,
    by stage) and every ``spread_accumulate`` call of one predict on the
    tensors the path hands it. Returns the batch-8 calls."""
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    rows = {}
    for b in (1, 8):
        batch, _ = scene_batch(cfg, b)
        ms = cuda_ms(lambda: infer(pipe, batch), iters=10)
        dev = pipe.device_batch(batch)
        stages = second_stage_ms(pipe, dev)
        with torch.no_grad():
            ms_dev = cuda_ms(lambda: pipe.predict(dev), iters=10)
        threshold, pipe.score_thr = pipe.score_thr, 0.0
        with torch.no_grad():
            ms_dev_nms = cuda_ms(lambda: pipe.predict(dev), iters=5)
        pipe.score_thr = threshold
        emit("second_predict", config="second_kitti", batch=b,
             ms_per_batch=ms, clouds_per_s=b * 1e3 / ms,
             device_resident_ms=ms_dev,
             device_resident_clouds_per_s=b * 1e3 / ms_dev,
             device_resident_ms_at_threshold_0=ms_dev_nms,
             stages_ms=stages)

        calls = []

        def rec_spread(vals, targets, *, num_out):
            calls.append((vals, targets, num_out))
            return sa.spread_accumulate(vals, targets, num_out=num_out)
        with swapped_segment_ops(sp.segment_paint, su.segment_unpaint,
                                 rec_spread), torch.no_grad():
            pipe.predict(dev)
        rows[b] = [spread_call_row(*call) for call in calls]
        for i, call in enumerate(rows[b]):
            emit("second_kernel", kernel="spread_accumulate", batch=b,
                 call=i, **call)
    return rows[8]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.weights import load_weights_npz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    gen = torch.Generator().manual_seed(0)

    phase_build()
    phase_kernel_check(gen)
    seg_err = phase_segment_kernel_check(gen)
    second_cfg = load_config(SECOND_CFG)
    second_pipe = build_model(second_cfg)          # weights from seed 0
    spread_err = phase_spread_kernel_check(second_pipe, second_cfg, gen)
    cfg = load_config(KITTI_CFG)
    pipe = build_model(cfg)
    load_weights_npz(pipe.model, WEIGHTS)
    launches, err = phase_main_path(pipe, cfg)
    phase_tiny_vs_cpu("pointpillars_tiny", TINY_CFG, keep_sets=True)
    second_launches = phase_second_serving(second_pipe, second_cfg)
    phase_tiny_vs_cpu("second_tiny", SECOND_TINY_CFG, keep_sets=False)
    train_pipe, train_cfg, train_batch, train_launches = phase_train_path(
        "pointpillars_fixture_hard_conv", TRAIN_CFG, WEIGHTS,
        POINTPILLARS_LAUNCHES_PER_TRAIN_STEP)
    second_train = phase_train_path(
        "second_fixture_conv", SECOND_TRAIN_CFG, None,
        SECOND_LAUNCHES_PER_TRAIN_STEP)
    timing = phase_timing(pipe, cfg)
    second_calls = phase_second_timing(second_pipe, second_cfg)
    train_rows = phase_train_timing("pointpillars_fixture_hard_conv",
                                    train_pipe, train_cfg, train_batch)
    second_train_rows = phase_train_timing("second_fixture_conv",
                                           *second_train[:3])

    def summed(per_call):
        library = [c["library_ms"] for c in per_call]
        return {
            "ms": sum(c["ms"] for c in per_call),
            "plain_ms": sum(c["plain_ms"] for c in per_call),
            "bound_ms": sum(c["bound_ms"] for c in per_call),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in per_call) else "operations",
            "library_ms": None if None in library else sum(library)}

    kernels = [{
        **ek.KERNEL_INFO, "launches": launches, "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    # The segment kernels: the times of one PointPillars train step's
    # calls together (three paints; the unpaints of the decoration and the
    # segment-max backward), each call also on its own under "calls". No
    # single PyTorch call computes a table of max and sum channels, so the
    # paint's library time stands only with its all-sum call. Their calls
    # in a SECOND train step stand beside them.
    for mod in (sp, su):
        name = mod.KERNEL_INFO["name"]
        kernels.append({
            **mod.KERNEL_INFO, "launches": train_launches[name],
            "max_abs_err": seg_err[name], **summed(train_rows[name]),
            "launches_per_train_step": train_launches[name] / TRAIN_STEPS,
            "launches_per_second_predict": second_launches[name],
            "launches_per_second_train_step":
                second_train[3][name] / TRAIN_STEPS,
            "calls": train_rows[name],
            "second_train_step": summed(second_train_rows[name])})
    # The spread kernel: the nine calls of one SECOND predict at batch 8
    # together; the nine of a train step at batch 4 beside them.
    name = sa.KERNEL_INFO["name"]
    kernels.append({
        **sa.KERNEL_INFO, "launches": second_launches[name],
        "max_abs_err": spread_err, **summed(second_calls),
        "launches_per_predict": second_launches[name],
        "launches_per_train_step": second_train[3][name] / TRAIN_STEPS,
        "calls": second_calls,
        "second_train_step": summed(second_train_rows[name])})
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
