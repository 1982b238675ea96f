#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lisec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it goes wrong:

1. build every CUDA kernel of the main paths from
   ``lisec_tpu_torch/csrc`` with nvcc for sm_90a, all at once;
2. hold each kernel against its plain PyTorch version on the card, at
   the main paths' shapes plus edge cases: the fused encoder on random
   clouds at KITTI geometry; ``segment_paint`` in its three channel
   splits and at the edges of its tiling, ``segment_unpaint``, and
   ``segment_max_sorted`` forward and backward (f32 inputs, and
   bf16-valued inputs full of ties);
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
   at batch 1 and 8 with its stages (and its two paint calls at batch
   8), both train steps and their parts at batch 4, and every kernel, its
   plain version, the encoder's sort glue and (where one exists) the
   PyTorch call for the same function at the main paths' shapes, with
   CUDA events;
7. PointNet++ part segmentation (``configs/pointnet2_partseg_fixture_conv
   .yaml`` at full width: SSG, 16 categories, 50 parts, 2048 points,
   seed-initialised weights, fixture clouds): ``fps``, ``gather_rows``
   and ``scatter_rows`` against their plain versions at the path's
   shapes and on edge cases (the scatter's tiling among them); predict
   through ``infer`` at batch 16 and 1 (2 FPS and 7 gather launches
   each, nothing else), the kernel route
   against the plain route; ``pointnet2_partseg_tiny`` on the card
   against the CPU; train steps at batch 16 (Adam, step schedule,
   augmentation; 3 scatter launches a step) held against the plain route
   with dropout made the identity, a short ``train(cfg)``; the predict by
   stage, the train step by part, every point-kernel call;
8. list under ``torch.profiler`` what ``scatter_rows`` and
   ``segment_paint`` calls run (the output's allocation and the
   kernel's own launch, nothing else), then take the device time of
   every timed call of the two (after the timed phases, so that no
   trace touches them);
9. print the ``{"kernels": [...]}`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Every comparison on the card runs with TF32 off for matrix products and
convolutions.

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
                  "spread_accumulate", "fps", "gather_rows")
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


def profiled(fn, iters: int):
    """``fn()`` ``iters`` times under ``torch.profiler`` (after one call
    outside it): the aten ops the host ran and the (name, microseconds)
    of every CUDA kernel the trace caught. A trace can miss the launches
    of its first microseconds, so callers count what it caught."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.elapsed_us()))
        elif e.name.startswith("aten::"):
            ops.append(e.name)
    return ops, kernels


# Per-call rows whose kernel's device time the last phase fills in, with
# the call that gives it: (kernel, row, fn). Every profiler trace of the
# run comes after its timed phases.
DEVICE_TIMED = []


def device_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds that the one CUDA kernel ``fn()`` launches spends
    on the card, over the launches a profiler trace of ``iters`` calls
    caught: the kernel's own time, without the host's share of the
    call."""
    _, kernels = profiled(fn, iters)
    if not kernels:
        raise AssertionError("the profiler caught no kernel launch")
    return sum(us for _, us in kernels) / len(kernels) / 1e3


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

    # The kernel's tiling (up to 1024 cells a block, fewer for wide tables)
    # on a table of 100,003 cells, no multiple of any tile: cloud 0 random
    # with negative ids at its head and an unsorted invalid tail, cloud 1
    # every row in one cell, cloud 2 every row invalid, cloud 3 hundreds of
    # rows on each cell around the tile edges at 1024 and 2048. Every C the
    # kernel treats apart (one channel a thread, four, four read as one
    # vector), with and without split.
    nc, n = 100_003, 40_000
    ids = torch.sort(torch.randint(0, nc, (4, n), generator=gen), 1).values
    ids[0, :300] = torch.sort(-torch.randint(1, 60, (300,), generator=gen)
                              ).values
    ids[0, -500:] = nc + torch.randint(0, 1000, (500,), generator=gen)
    ids[1] = 77_777
    ids[2, :100] = -1
    ids[2, 100:] = nc + torch.randint(0, 1000, (n - 100,), generator=gen)
    ids[3] = torch.sort(torch.cat([
        torch.randint(1000, 1050, (n // 2,), generator=gen),
        torch.randint(2040, 2056, (n // 4,), generator=gen),
        torch.randint(0, nc, (n - n // 2 - n // 4,), generator=gen)])).values
    ids = ids.to(torch.int32).cuda()
    for c, num_max in ((1, 0), (1, 1), (3, 0), (3, 2), (4, 0), (4, 2),
                       (8, 0), (8, 4), (65, 0), (65, 64)):
        vals = torch.randn((4, n, c), generator=gen).cuda()
        got = sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max)
        torch.cuda.synchronize()
        ref = sp.segment_paint_reference(vals, ids, num_cells=nc,
                                         num_max=num_max)
        what = f"segment_paint tiling c{c} num_max{num_max}"
        err, bits = check_paint(got, ref, num_max, what)
        if not torch.equal(got, sp.segment_paint(vals, ids, num_cells=nc,
                                                 num_max=num_max)):
            raise AssertionError(f"{what}: two runs differ")
        splits = [c - 1] if c > 1 else []
        for split in splits:
            head, tail = sp.segment_paint(vals, ids, num_cells=nc,
                                          num_max=num_max, split=split)
            if not (torch.equal(head, got[..., :split])
                    and torch.equal(tail, got[..., split:])):
                raise AssertionError(f"{what} split {split}: the two-part "
                                     "table differs")
        empty = got[2]
        if not ((empty[:, :num_max] == sp.EMPTY_MAX).all()
                and (empty[:, num_max:] == 0).all()):
            raise AssertionError(f"{what}: the all-invalid cloud's table")
        worst["segment_paint"] = max(worst["segment_paint"], err)
        emit("kernel_check", kernel="segment_paint", case="tiling_edges",
             shape=list(got.shape), num_max=num_max, splits=splits,
             max_channels="bit-equal", sum_max_abs_err=err,
             sum_elements_differing=bits, two_runs_identical=True)

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


def paint_call_row(vals, ids, nc, num_max, split):
    """One ``segment_paint`` call timed on the tensors a path handed it:
    the wrapper (one launch, no glue; ``device_ms``, filled in at the end,
    the kernel's own time on the card), its plain version, its bound, and
    for an all-sum table ``index_add_`` as the one PyTorch call for the
    same function (on a table with a trash row per cloud, f32 atomics). No
    single PyTorch call computes a table of max and sum channels."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    b, _, c = vals.shape
    bound, by, nbytes = paint_bound(vals, ids, nc)
    library = None
    if num_max == 0:
        rows_ix = (torch.where((ids < 0) | (ids >= nc), nc, ids).long()
                   + torch.arange(b, device="cuda")[:, None] * (nc + 1)
                   ).reshape(-1)
        flat = vals.reshape(-1, c)
        library = cuda_ms(lambda: torch.zeros(
            (b * (nc + 1), c), device="cuda").index_add_(0, rows_ix, flat), 20)

    def call():
        return sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max,
                                split=split)
    row = dict(
        rows=list(vals.shape), table_rows=nc, num_max=num_max, split=split,
        rows_placed=int(((ids >= 0) & (ids < nc)).sum()),
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: sp.segment_paint_reference(
            vals, ids, num_cells=nc, num_max=num_max, split=split), 5),
        library_ms=library, bound_ms=bound, bound_by=by, bytes=nbytes)
    DEVICE_TIMED.append(("segment_paint", row, call))
    return row


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

    rows["segment_paint"] = [paint_call_row(*call)
                             for call in calls["segment_paint"]]

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
    by stage), every ``spread_accumulate`` call of one predict on the
    tensors the path hands it, and at batch 8 its two ``segment_paint``
    calls. Returns the batch-8 spread and paint calls."""
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

        calls, paints = [], []

        def rec_spread(vals, targets, *, num_out):
            calls.append((vals, targets, num_out))
            return sa.spread_accumulate(vals, targets, num_out=num_out)

        def rec_paint(vals, ids, *, num_cells, num_max, split=None):
            paints.append((vals, ids, num_cells, num_max, split))
            return sp.segment_paint(vals, ids, num_cells=num_cells,
                                    num_max=num_max, split=split)
        with swapped_segment_ops(rec_paint, su.segment_unpaint,
                                 rec_spread), torch.no_grad():
            pipe.predict(dev)
        rows[b] = ([spread_call_row(*call) for call in calls],
                   [paint_call_row(*call) for call in paints] if b == 8
                   else [])
        for kernel, per_call in zip(("spread_accumulate", "segment_paint"),
                                    rows[b]):
            for i, call in enumerate(per_call):
                emit("second_kernel", kernel=kernel, batch=b, call=i, **call)
    if len(rows[8][1]) != SECOND_LAUNCHES_PER_PREDICT["segment_paint"]:
        raise AssertionError(f"second predict paint calls {len(rows[8][1])}")
    return rows[8]


# -- PointNet++: the point kernels, serving, training, timing ----------------

PARTSEG_CFG = os.path.join(ROOT, "configs",
                           "pointnet2_partseg_fixture_conv.yaml")
PARTSEG_TINY_CFG = os.path.join(ROOT, "configs", "pointnet2_partseg_tiny.yaml")
# The gathers of a full-width predict at batch 16: (source rows, C, ids per
# cloud); and the scatters of its train step: (rows, C, table rows).
PARTSEG_GATHER_SHAPES = ((2048, 3, 512), (2048, 3, 16384), (512, 3, 128),
                         (512, 3, 8192), (512, 128, 8192), (128, 256, 1536),
                         (512, 128, 6144))
PARTSEG_SCATTER_SHAPES = ((8192, 128, 512), (1536, 256, 128),
                          (6144, 128, 512))
PARTSEG_LAUNCHES_PER_PREDICT = {
    "pillar_canvas_fused": 0, "segment_paint": 0, "segment_unpaint": 0,
    "spread_accumulate": 0, "fps": 2, "gather_rows": 7, "scatter_rows": 0}
PARTSEG_LAUNCHES_PER_TRAIN_STEP = {**PARTSEG_LAUNCHES_PER_PREDICT,
                                   "scatter_rows": 3}


def point_launches():
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    return {"fps": fk.LAUNCHES, "gather_rows": gr.GATHER_LAUNCHES,
            "scatter_rows": gr.SCATTER_LAUNCHES}


def all_launches():
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    return {"pillar_canvas_fused": ek.LAUNCHES, **segment_launches(),
            **point_launches()}


def zero_all_launches():
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    zero_segment_launches()
    ek.LAUNCHES = fk.LAUNCHES = 0
    gr.GATHER_LAUNCHES = gr.SCATTER_LAUNCHES = 0


@contextlib.contextmanager
def swapped_point_ops(fps, gather, scatter):
    """Swap ``fps`` (as ``ops/fps.py`` calls it), ``gather_rows`` and
    ``scatter_rows`` (as ``GatherRows`` calls them), here only: the
    package has no switch on the card."""
    from lisec_tpu_torch.ops import fps as fps_op
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    saved = [(fps_op, "fps", fps_op.fps), (gr, "gather_rows", gr.gather_rows),
             (gr, "scatter_rows", gr.scatter_rows)]
    fps_op.fps, gr.gather_rows, gr.scatter_rows = fps, gather, scatter
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_point_ops():
    """The point kernels' callers on their plain PyTorch versions."""
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    return swapped_point_ops(fk.fps_reference, gr.gather_rows_reference,
                             gr.scatter_rows_reference)


def partseg_batch(pipe, cfg, b, split="test"):
    """The first ``b`` fixture clouds of ``split``, padded (no
    augmentation)."""
    from lisec_tpu_torch.data.collate import make_batches
    return next(make_batches(pipe.make_dataset(split), cfg.budget, b,
                             shuffle=False))


def phase_point_kernel_check(pipe, cfg, gen):
    """``fps``, ``gather_rows`` and ``scatter_rows`` on the card against
    their plain versions at the PointNet++ path's full-width shapes and on
    edge cases: FPS picks and gathers equal to the bit, the scatter equal
    to the bit and twice identical. Returns the largest |difference| seen
    for each kernel."""
    import torch
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    g = torch.Generator(device="cuda").manual_seed(gen.initial_seed())
    worst = dict.fromkeys(("fps", "gather_rows", "scatter_rows"), 0.0)

    def check_fps(what, pts, mask, m):
        got = fk.fps(pts, mask, m)
        torch.cuda.synchronize()
        ref = fk.fps_reference(pts, mask, m)
        if not torch.equal(got, ref):
            raise AssertionError(f"fps {what}: {int((got != ref).sum())} "
                                 "picks differ from the plain version")
        picked_valid = mask.gather(1, got.long())
        some = mask.any(1)
        if not picked_valid[some].all() or got[~some].any():
            raise AssertionError(f"fps {what}: a masked point was picked")
        emit("kernel_check", kernel="fps", case=what,
             points=list(pts.shape), samples=m, picks_equal=True,
             valid_points_per_cloud=mask.sum(1).tolist()[:8],
             distinct_picks_per_cloud=[len(set(r)) for r in
                                       got.tolist()][:8])
        return got

    dev = pipe.device_batch(partseg_batch(pipe, cfg, 16))
    pts, mask = dev["points"].contiguous(), dev["point_mask"]
    idx1 = check_fps("sa1_full_width", pts, mask, 512)
    check_fps("sa2_full_width", gr.gather_rows(pts, idx1),
              mask.gather(1, idx1.long()), 128)
    n = 1500                          # no multiple of the 1024-thread block
    pts = torch.rand((4, n, 3), generator=g, device="cuda")
    mask = torch.rand((4, n), generator=g, device="cuda") > 0.1
    mask[0] = False                                  # all masked
    mask[1] = False
    mask[1, ::37] = True                             # 41 valid, M = 128
    mask[2] = True
    mask[2, 300:900] = False                         # masked middle
    pts[3] = torch.randint(-2, 3, (n, 3), generator=g,
                           device="cuda").float()   # ties, duplicates
    got = check_fps("edge_cases", pts, mask, 128)
    if len(set(got[1].tolist())) != 41:
        raise AssertionError("fps: the short cloud's picks")
    check_fps("batch_1_m_equals_n", pts[2:3].contiguous(), mask[2:3].clone(),
              n)

    def check_gather(what, src, idx):
        got = gr.gather_rows(src, idx)
        torch.cuda.synchronize()
        ref = gr.gather_rows_reference(src, idx)
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_rows {what} {src.dtype}: "
                                 f"{int((got != ref).sum())} elements differ")
        emit("kernel_check", kernel="gather_rows", case=what,
             src=list(src.shape), ids=list(idx.shape), dtype=str(src.dtype),
             bit_equal=True)

    for rows, c, m in PARTSEG_GATHER_SHAPES:
        idx = torch.randint(0, rows, (16, m), generator=g, device="cuda",
                            dtype=torch.int32)
        src = torch.randn((16, rows, c), generator=g, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            check_gather("full_width", src.to(dtype), idx)
    for c in (1, 3, 5, 64):
        src = torch.randn((4, 100, c), generator=g, device="cuda")
        idx = torch.randint(-3, 104, (4, 333), generator=g, device="cuda",
                            dtype=torch.int32)         # -1.. and >= N
        idx[0, :3] = torch.tensor([-1, 100, 99], dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            check_gather(f"ids_out_of_range_c{c}_m333", src.to(dtype), idx)

    def check_scatter(what, vals, idx, num_rows):
        got = gr.scatter_rows(vals, idx, num_rows=num_rows)
        torch.cuda.synchronize()
        again = gr.scatter_rows(vals, idx, num_rows=num_rows)
        ref = gr.scatter_rows_reference(vals, idx, num_rows=num_rows)
        err = float((got - ref).abs().max())
        worst["scatter_rows"] = max(worst["scatter_rows"], err)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"scatter_rows {what}: {int((got != ref).sum())} elements "
                f"differ from the plain version, max |d| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"scatter_rows {what}: two runs differ")
        ok = (idx >= 0) & (idx < num_rows)
        hits = torch.zeros((idx.shape[0], num_rows + 1), device="cuda")
        hits.scatter_add_(1, torch.where(ok, idx, num_rows).long(),
                          torch.ones_like(idx, dtype=torch.float32))
        emit("kernel_check", kernel="scatter_rows", case=what,
             vals=list(vals.shape), num_rows=num_rows,
             rows_landed=int(ok.sum()),
             most_rows_on_one_target=int(hits[:, :num_rows].max()),
             bit_equal=True, two_runs_identical=True, max_abs_err=err)
        return got

    for m, c, r in PARTSEG_SCATTER_SHAPES:
        # Runs of repeated ids, as the ball query's repeat-fill makes them.
        idx = torch.randint(0, r, (16, m), generator=g, device="cuda",
                            dtype=torch.int32)
        rep = torch.rand((16, m), generator=g, device="cuda") < 0.4
        rep[:, 0] = False
        last_new = torch.cummax(torch.where(rep, -1, torch.arange(
            m, device="cuda")), dim=1).values
        idx = idx.gather(1, last_new).to(torch.int32).contiguous()
        check_scatter("full_width", torch.randn((16, m, c), generator=g,
                                                device="cuda"), idx, r)
    vals = torch.randn((2, 4096, 64), generator=g, device="cuda")
    got = check_scatter("every_row_onto_one_target", vals,
                        torch.full((2, 4096), 511, dtype=torch.int32,
                                   device="cuda"), 512)
    if got[:, :511].any():
        raise AssertionError("scatter_rows: rows beside the one target")
    dropped = torch.where(torch.rand((2, 4096), generator=g, device="cuda")
                          < 0.5, -1, 512).to(torch.int32)
    if check_scatter("all_rows_dropped", vals, dropped, 512).any():
        raise AssertionError("scatter_rows: a dropped row landed")
    desc = torch.sort(torch.randint(0, 512, (2, 4096), generator=g,
                                    device="cuda"), dim=1,
                      descending=True).values.to(torch.int32)
    check_scatter("descending_ids", vals, desc, 512)

    # The kernel's tiling: tables of 33 and 1000 rows (no multiple of any
    # tile) with ids beyond both ends, at every C it treats apart (one
    # channel a thread, four, more than one channel block); 100,000 rows;
    # M = 1; M above a 2048-id chunk (2^16 + 5, repeat-filled); 5,000 rows
    # of 8192 on one target (more than a chunk); a vals pointer that is not
    # 16-byte aligned (a contiguous view at an offset of one float).
    def ids(b, m, r):
        return torch.randint(-3, r + 3, (b, m), generator=g, device="cuda",
                             dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    for r in (33, 1000):
        for c in (1, 3, 5, 128, 256):
            check_scatter(f"rows{r}_c{c}", randn(4, 3000, c), ids(4, 3000, r),
                          r)
    check_scatter("rows100000", randn(2, 8192, 128), ids(2, 8192, 100_000),
                  100_000)
    for c in (3, 128):
        check_scatter(f"m1_c{c}", randn(3, 1, c), torch.tensor(
            [[0], [2], [-1]], dtype=torch.int32, device="cuda"), 3)
    m = 2 ** 16 + 5
    rep = torch.rand((2, m), generator=g, device="cuda") < 0.6
    rep[:, 0] = False
    last_new = torch.cummax(torch.where(rep, -1, torch.arange(
        m, device="cuda")), dim=1).values
    check_scatter("m_65541_repeat_fill", randn(2, m, 64), ids(2, m, 512)
                  .gather(1, last_new).contiguous(), 512)
    many = torch.randint(0, 512, (2, 8192), generator=g, device="cuda",
                         dtype=torch.int32)
    many[:, torch.randperm(8192, generator=g, device="cuda")[:5000]] = 17
    check_scatter("5000_rows_on_one_target", randn(2, 8192, 128), many, 512)
    buf = randn(2 * 4096 * 128 + 1)[1:].view(2, 4096, 128).contiguous()
    if buf.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    check_scatter("vals_not_16_byte_aligned", buf, ids(2, 4096, 512), 512)
    return worst


def phase_partseg_serving(pipe, cfg):
    """Full-width PointNet++ predict at batch 16 and 1 through ``infer``:
    launches (2 FPS and 7 gathers per predict, nothing else), outputs,
    and the kernel route against the plain route on the card."""
    import torch
    from lisec_tpu_torch.api import infer
    per_batch = {}
    for b in (16, 1):
        batch = partseg_batch(pipe, cfg, b)
        zero_all_launches()
        out = infer(pipe, batch)
        torch.cuda.synchronize()
        launches = all_launches()
        if launches != PARTSEG_LAUNCHES_PER_PREDICT:
            raise AssertionError(f"partseg predict launches {launches}, "
                                 f"expected {PARTSEG_LAUNCHES_PER_PREDICT}")
        logits, labels = out["logits"], out["labels"]
        if logits.shape != (b, cfg.budget.max_points, pipe.num_parts) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"partseg logits {tuple(logits.shape)}")
        if labels.dtype != torch.int32 or labels.min() < 0 \
                or labels.max() >= pipe.num_parts:
            raise AssertionError("partseg labels")
        before = all_launches()
        with plain_point_ops():
            plain = infer(pipe, batch)
        if all_launches() != before:
            raise AssertionError("the plain route launched a kernel")
        diff = float((logits - plain["logits"]).abs().max())
        scale = float(plain["logits"].abs().max())
        if diff > 1e-5 * scale or not torch.equal(labels, plain["labels"]):
            raise AssertionError(f"partseg kernel vs plain route: logits "
                                 f"differ by {diff} (largest {scale})")
        point_acc = float((labels.long() == torch.as_tensor(
            batch["point_labels"], device="cuda")).float().mean())
        emit("partseg_main_path", config="pointnet2_partseg_fixture_conv",
             batch=b, launches=launches, logits_max_abs=scale,
             max_abs_diff_vs_plain=diff,
             matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
             logits_bit_equal_to_plain=bool(torch.equal(logits,
                                                        plain["logits"])),
             labels_equal_to_plain=True,
             point_accuracy_seed_weights=point_acc)
        per_batch[b] = launches
    return per_batch[16]


def phase_partseg_tiny_vs_cpu():
    """``pointnet2_partseg_tiny`` (seed-initialised) on the card against
    the CPU: labels equal except where the top two logits lie within
    1e-5."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    cfg = load_config(PARTSEG_TINY_CFG)
    outs = []
    for d in ("cuda", "cpu"):
        pipe = build_model(cfg, d)
        batch = partseg_batch(pipe, cfg, cfg.train.batch_size, "train")
        outs.append({k: v.cpu() for k, v in infer(pipe, batch, d).items()})
    top2 = torch.topk(outs[1]["logits"], 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    differ = outs[0]["labels"] != outs[1]["labels"]
    if (differ & ~near).any():
        raise AssertionError(f"pointnet2_partseg_tiny cuda vs cpu: "
                             f"{int((differ & ~near).sum())} labels differ")
    emit("tiny_vs_cpu", config="pointnet2_partseg_tiny",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         logits_max_abs_diff=float((outs[0]["logits"]
                                    - outs[1]["logits"]).abs().max()),
         logits_max_abs=float(outs[1]["logits"].abs().max()),
         labels_differing=int(differ.sum()),
         points_with_top_two_within_1e_5=int(near.sum()),
         points=int(near.numel()))


def partseg_loss_and_grads(pipe, batch):
    import torch
    pipe.model.train()
    pipe.optimizer.zero_grad()
    with torch.enable_grad():
        loss, aux = pipe.loss(pipe.device_batch(batch))
        loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), aux["acc"].detach(),
            {n: p.grad.clone() for n, p in pipe.model.named_parameters()})


def phase_partseg_train():
    """Full-width PointNet++ train steps at batch 16 (Adam, the step
    schedule, augmentation on) through ``train_step``: launches (2 FPS, 7
    gathers, 3 scatters a step), finite loss, every tensor moved; the first
    step's loss and gradients against the same step over the plain
    versions, dropout made the identity for that comparison; then a short
    ``lisec_tpu_torch.train`` whose loss falls."""
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.config import apply_overrides, load_config
    from lisec_tpu_torch.data.collate import make_batches
    cfg = apply_overrides(load_config(PARTSEG_CFG), [
        'train.ckpt_dir=""', f"train.num_steps={TRAIN_STEPS}",
        "train.log_every=1"])
    if not cfg.data.augment.enabled or cfg.train.schedule != "step":
        raise AssertionError("partseg training config: augmentation and the "
                             "step schedule must be on")
    pipe = build_model(cfg)
    pipe.init_state(cfg.train.seed)
    batches = make_batches(pipe.make_dataset("train"), cfg.budget,
                           cfg.train.batch_size, shuffle=True,
                           seed=cfg.train.seed,
                           augment_fn=pipe.augment_fn("train"))
    first = next(batches)
    start = {k: v.clone() for k, v in pipe.model.state_dict().items()}

    zero_all_launches()
    with torch.enable_grad():
        auxes = [pipe.train_step(first if i == 0 else next(batches))
                 for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = all_launches()
    want = {k: v * TRAIN_STEPS
            for k, v in PARTSEG_LAUNCHES_PER_TRAIN_STEP.items()}
    if launches != want:
        raise AssertionError(f"partseg train launches {launches} in "
                             f"{TRAIN_STEPS} steps, expected {want}")
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    for a in auxes:
        if not all(v == v and abs(v) != float("inf") for v in a.values()):
            raise AssertionError(f"partseg train step: non-finite {a}")
    stuck = [k for k, v in pipe.model.state_dict().items()
             if torch.equal(v, start[k])]
    if stuck or pipe.step != TRAIN_STEPS:
        raise AssertionError(f"partseg train step: unchanged {stuck}, "
                             f"step {pipe.step}")
    emit("partseg_train_path", config="pointnet2_partseg_fixture_conv",
         batch=cfg.train.batch_size, steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         per_step=auxes, tensors_moved=len(start))

    # Kernels against plain versions, dropout the identity: the gathers
    # and FPS are exact on both routes and the scatter adds in the same
    # order, so the loss within 1e-5 relative and every gradient within
    # 1e-3 of its own L2 norm (bit-equal expected).
    pipe.model.dropout_rate = 0.0
    pipe.model.load_state_dict(start)
    loss_k, acc_k, grads_k = partseg_loss_and_grads(pipe, first)
    pipe.model.load_state_dict(start)
    before = all_launches()
    with plain_point_ops():
        loss_p, acc_p, grads_p = partseg_loss_and_grads(pipe, first)
    if all_launches() != before:
        raise AssertionError("the plain run launched a kernel")
    pipe.model.dropout_rate = 0.4
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if rel_loss > 1e-5 or float(acc_k) != float(acc_p):
        raise AssertionError(f"partseg loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    worst, worst_name = 0.0, ""
    for pname, gk in grads_k.items():
        gp = grads_p[pname]
        rel = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, pname
    if worst > 1e-3:
        raise AssertionError(f"partseg gradient of {worst_name}: relative "
                             f"L2 difference {worst} from the plain run")
    emit("train_vs_plain", config="pointnet2_partseg_fixture_conv",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         dropout="identity", loss=float(loss_k), plain_loss=float(loss_p),
         loss_rel_diff=rel_loss, worst_grad_rel_l2=worst,
         worst_grad=worst_name, gradients=len(grads_k),
         gradients_bit_equal=all(torch.equal(grads_k[k], grads_p[k])
                                 for k in grads_k))

    short = apply_overrides(cfg, ["train.num_steps=8", "train.log_every=2"])
    with torch.enable_grad():
        trained, history = lisec_tpu_torch.train(short, progress=False)
    torch.cuda.synchronize()
    if len(history) != 5 or trained.step != 8:
        raise AssertionError(f"partseg train(): {len(history)} records")
    if not (history[-1]["loss"] + history[-2]["loss"]) / 2 \
            < history[0]["loss"]:
        raise AssertionError(f"partseg train() loss did not fall: "
                             f"{[r['loss'] for r in history]}")
    emit("train_entry_point", config="pointnet2_partseg_fixture_conv",
         steps=8, loss_per_logged_step={r["step"]: r["loss"]
                                        for r in history},
         acc_per_logged_step={r["step"]: r["acc"] for r in history},
         lr={r["step"]: r["lr"] for r in history})
    pipe.model.load_state_dict(start)
    return pipe, cfg, first, launches


def fps_call_row(points, mask, m):
    """One ``fps`` call timed on the tensors the path handed it. Bound:
    about 10 f32 operations per valid point per round over the f32 rate,
    against the points, mask and picks over the memory rate."""
    from lisec_tpu_torch.ops.cuda import fps as fk
    valid = int(mask.sum())
    nbytes = points.nbytes + mask.nbytes + points.shape[0] * m * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * valid * (m - 1) / F32_FLOPS * 1e3
    return dict(
        points=list(points.shape), samples=m, valid_points=valid,
        ms=cuda_ms(lambda: fk.fps(points, mask, m), 20),
        plain_ms=cuda_ms(lambda: fk.fps_reference(points, mask, m), 3),
        library_ms=None, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, operations=10 * valid * (m - 1))


def gather_call_row(src, idx):
    """One ``gather_rows`` call: the kernel, its plain version,
    ``torch.gather`` on the same tensors, and its bound (the ids, the rows
    they name and the output over the memory rate)."""
    import torch
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    b, n, c = src.shape
    ok = (idx >= 0) & (idx < n)
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None] * n
    rows_read = int(torch.unique(flat[ok]).numel())
    esize = src.element_size()
    nbytes = idx.nbytes + rows_read * c * esize + idx.numel() * c * esize
    idx64 = torch.where(ok, idx, 0).long()[..., None].expand(-1, -1, c)
    return dict(
        src=list(src.shape), ids=list(idx.shape), dtype=str(src.dtype),
        rows_read=rows_read,
        ms=cuda_ms(lambda: gr.gather_rows(src, idx), 20),
        plain_ms=cuda_ms(lambda: gr.gather_rows_reference(src, idx), 5),
        library_ms=cuda_ms(lambda: torch.gather(src, 1, idx64), 20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)


def scatter_call_row(vals, idx, num_rows):
    """One ``scatter_rows`` call: the wrapper (one launch, no glue;
    ``device_ms``, filled in at the end, the kernel's own time on the
    card), its plain version, ``index_add_`` (f32 atomics in no fixed
    order) and its bound (ids, the values of the rows that land and the
    table over the memory rate, against one add per landed
    row-channel)."""
    import torch
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    b, m, c = vals.shape
    ok = (idx >= 0) & (idx < num_rows)
    landed = int(ok.sum())
    nbytes = idx.nbytes + landed * c * 4 + b * num_rows * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = landed * c / F32_FLOPS * 1e3
    rows = (torch.where(ok, idx, num_rows).long()
            + torch.arange(b, device="cuda")[:, None] * (num_rows + 1)
            ).reshape(-1)
    flat = vals.reshape(-1, c)
    counts = torch.bincount(rows, minlength=b * (num_rows + 1))
    def call():
        return gr.scatter_rows(vals, idx, num_rows=num_rows)
    row = dict(
        vals=list(vals.shape), num_rows=num_rows, rows_landed=landed,
        most_rows_on_one_target=int(counts.view(b, -1)[:, :num_rows].max()),
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: gr.scatter_rows_reference(
            vals, idx, num_rows=num_rows), 3),
        library_ms=cuda_ms(lambda: torch.zeros(
            (b * (num_rows + 1), c), device="cuda").index_add_(
                0, rows, flat), 20),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes)
    DEVICE_TIMED.append(("scatter_rows", row, call))
    return row


def partseg_stage_ms(pipe, dev, runs=5):
    """Mean ms of a device-resident predict's stages, by events around the
    model's own calls (wrapped here only): FPS, ball query, grouping (the
    SA gathers), the SA and global MLPs, feature propagation (FP3, 3-NN,
    interpolation, MLPs) and the head."""
    import torch
    from lisec_tpu_torch.models import pointnet2
    model = pipe.model
    timer = EventTimer()
    functions = {"farthest_point_sampling": "fps", "ball_query": "ball_query",
                 "gather_points": "grouping",
                 "group_and_decorate": "grouping"}
    wrapped = [(mlp, "forward", "sa_mlps") for sa in model.sa
               for mlp in sa.mlps]
    wrapped += [(model.global_sa, "forward", "sa_mlps"),
                (model.fp3, "forward", "fp"), (model.fp[0], "forward", "fp"),
                (model.fp[1], "forward", "fp"),
                (model.head_dense, "forward", "head"),
                (model.head_bn, "forward", "head"),
                (model.head_out, "forward", "head")]
    saved = {f: getattr(pointnet2, f) for f in functions}

    def run():
        with torch.no_grad():
            pipe.predict(dev)
    run()
    run()
    try:
        for obj, attr, name in wrapped:
            setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))
        for f, name in functions.items():
            setattr(pointnet2, f, timer.wrap(name, saved[f]))
        total = cuda_ms(run, iters=runs, warmup=0)
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
        for f, fn in saved.items():
            setattr(pointnet2, f, fn)
    ms = timer.ms_per_run(runs)
    ms["rest"] = total - sum(ms.values())
    ms["predict"] = total
    return ms


def phase_partseg_timing(serve_pipe, serve_cfg, train_pipe, train_cfg,
                         train_batch):
    """PointNet++ predict at batch 16 and 1 (from host numpy,
    device-resident, by stage), the train step at batch 16 and its parts,
    and every point-kernel call of a batch-16 predict (FPS, gathers) and
    of a train step's backward (scatters) on the tensors the path hands
    it. Returns (fps rows, gather rows, scatter rows)."""
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.training.losses import cross_entropy
    for b in (16, 1):
        batch = partseg_batch(serve_pipe, serve_cfg, b)
        ms = cuda_ms(lambda: infer(serve_pipe, batch), iters=10)
        dev = serve_pipe.device_batch(batch)
        with torch.no_grad():
            ms_dev = cuda_ms(lambda: serve_pipe.predict(dev), iters=10)
        emit("partseg_predict", config="pointnet2_partseg_fixture_conv",
             batch=b, ms_per_batch=ms, clouds_per_s=b * 1e3 / ms,
             device_resident_ms=ms_dev,
             device_resident_clouds_per_s=b * 1e3 / ms_dev,
             stages_ms=partseg_stage_ms(serve_pipe, dev))

    pipe, b = train_pipe, train_cfg.train.batch_size
    with torch.enable_grad():
        ms_step = cuda_ms(lambda: pipe.train_step(train_batch), iters=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            pipe.train_step(train_batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        dev = pipe.device_batch(train_batch)
        parts = dict.fromkeys(("forward", "loss", "backward", "optimizer"),
                              0.0)
        for it in range(7):                          # 2 warm-up + 5
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            pipe.model.train()
            pipe.optimizer.zero_grad()
            ev[0].record()
            logits = pipe.model(*pipe._model_args(dev),
                                generator=pipe.dropout_generator)
            ev[1].record()
            loss = cross_entropy(logits, dev["point_labels"],
                                 mask=dev["point_mask"])
            ev[2].record()
            loss.backward()
            ev[3].record()
            pipe.optimizer.step()
            ev[4].record()
            torch.cuda.synchronize()
            if it >= 2:
                for i, k in enumerate(parts):
                    parts[k] += ev[i].elapsed_time(ev[i + 1]) / 5
    emit("partseg_train_step", config="pointnet2_partseg_fixture_conv",
         batch=b, ms_per_step=ms_step, clouds_per_s=b * 1e3 / ms_step,
         host_clock_ms_per_step=host_ms,
         host_clock_clouds_per_s=b * 1e3 / host_ms,
         **{f"{k}_ms": v for k, v in parts.items()})

    # Record what one batch-16 predict and one train step hand the kernels.
    calls = {"fps": [], "gather_rows": [], "scatter_rows": []}
    gather, scatter = gr.gather_rows, gr.scatter_rows   # before the swap

    def rec_fps(points, mask, m):
        calls["fps"].append((points, mask, m))
        return fk.fps(points, mask, m)

    def rec_gather(src, idx):
        calls["gather_rows"].append((src.detach(), idx))
        return gather(src, idx)

    def rec_scatter(vals, idx, *, num_rows):
        calls["scatter_rows"].append((vals, idx, num_rows))
        return scatter(vals, idx, num_rows=num_rows)

    dev = serve_pipe.device_batch(partseg_batch(serve_pipe, serve_cfg, 16))
    with swapped_point_ops(rec_fps, rec_gather, rec_scatter):
        with torch.no_grad():
            serve_pipe.predict(dev)
        predict_calls = {k: list(v) for k, v in calls.items()}
        calls["scatter_rows"].clear()
        partseg_loss_and_grads(pipe, train_batch)
    rows = (
        [fps_call_row(*c) for c in predict_calls["fps"]],
        [gather_call_row(*c) for c in predict_calls["gather_rows"]],
        [scatter_call_row(*c) for c in calls["scatter_rows"]])
    for kernel, per_call in zip(("fps", "gather_rows", "scatter_rows"), rows):
        for i, call in enumerate(per_call):
            emit("partseg_kernel", kernel=kernel, call=i, **call)
    if [len(r) for r in rows] != [2, 7, 3]:
        raise AssertionError(f"partseg kernel calls {[len(r) for r in rows]}")
    return rows


def phase_device_times():
    """The kernel's own time on the card (``device_ms``) of every timed
    ``segment_paint`` and ``scatter_rows`` call, filled into its row."""
    for kernel, row, call in DEVICE_TIMED:
        row["device_ms"] = device_ms(call)
        emit("device_time", kernel=kernel,
             call={k: row[k] for k in ("rows", "vals", "table_rows",
                                       "num_rows", "num_max", "split")
                   if k in row},
             ms=row["ms"], device_ms=row["device_ms"],
             library_ms=row["library_ms"], bound_ms=row["bound_ms"])


def phase_profile_listing():
    """Five ``scatter_rows`` calls (a PointNet++ gradient's shape) and
    five ``segment_paint`` calls (the encoder statistics' shape) under
    ``torch.profiler``: the aten ops on the host and the kernels on the
    card. Each call allocates its output (``aten::new_empty``, which
    runs ``aten::empty``) and launches its own kernel, and nothing else:
    no sort, no ``searchsorted``."""
    import torch
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    g = torch.Generator(device="cuda").manual_seed(5)
    vals = torch.randn((16, 8192, 128), generator=g, device="cuda")
    idx = torch.randint(0, 512, (16, 8192), generator=g, device="cuda",
                        dtype=torch.int32)
    rows = torch.randn((4, 32768, 4), generator=g, device="cuda")
    cells = torch.sort(torch.randint(0, NCELLS + 2000, (4, 32768), generator=g,
                                     device="cuda"), 1).values.to(torch.int32)
    calls = {
        "scatter_rows": (lambda: gr.scatter_rows(vals, idx, num_rows=512),
                         "scatter_kernel"),
        "segment_paint": (lambda: sp.segment_paint(
            rows, cells, num_cells=NCELLS, num_max=0), "segment_paint_kernel")}
    for name, (call, kernel) in calls.items():
        ops, kernels = profiled(call, 5)
        names = sorted({k for k, _ in kernels})
        emit("profile", kernel=name, calls=5, host_aten_ops=sorted(set(ops)),
             aten_ops_per_call=len(ops) / 5, cuda_kernels=names,
             launches_caught=len(kernels))
        # The output's allocation: new_empty, which dispatches to empty.
        if set(ops) - {"aten::new_empty", "aten::empty"} or not kernels \
                or any(kernel not in k for k in names):
            raise AssertionError(f"{name}: 5 calls ran {sorted(set(ops))} "
                                 f"and launched {names}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
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
    second_calls, second_paints = phase_second_timing(second_pipe,
                                                      second_cfg)
    train_rows = phase_train_timing("pointpillars_fixture_hard_conv",
                                    train_pipe, train_cfg, train_batch)
    second_train_rows = phase_train_timing("second_fixture_conv",
                                           *second_train[:3])
    partseg_cfg = load_config(PARTSEG_CFG)
    partseg_pipe = build_model(partseg_cfg)        # weights from seed 0
    point_err = phase_point_kernel_check(partseg_pipe, partseg_cfg, gen)
    partseg_launches = phase_partseg_serving(partseg_pipe, partseg_cfg)
    phase_partseg_tiny_vs_cpu()
    partseg_train = phase_partseg_train()
    fps_rows, gather_rows_, scatter_rows_ = phase_partseg_timing(
        partseg_pipe, partseg_cfg, *partseg_train[:3])
    partseg_train_launches = partseg_train[3]
    phase_profile_listing()
    phase_device_times()

    def summed(per_call):
        library = [c["library_ms"] for c in per_call]
        return {
            "ms": sum(c["ms"] for c in per_call),
            "plain_ms": sum(c["plain_ms"] for c in per_call),
            "bound_ms": sum(c["bound_ms"] for c in per_call),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in per_call) else "operations",
            "library_ms": None if None in library else sum(library),
            **({"device_ms": sum(c["device_ms"] for c in per_call)}
               if all("device_ms" in c for c in per_call) else {})}

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
    # in a SECOND train step stand beside them, and the paint's two calls
    # of a SECOND predict at batch 8.
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
            "second_train_step": summed(second_train_rows[name]),
            **({"second_predict": summed(second_paints),
                "second_predict_calls": second_paints}
               if mod is sp else {})})
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
    # The point kernels: FPS and the gathers as the calls of one PointNet++
    # predict at batch 16 together, the scatters as the three of one train
    # step at batch 16 (the gathers' backward).
    for info, rows, launches_, err_ in (
            (fk.KERNEL_INFO, fps_rows, partseg_launches["fps"],
             point_err["fps"]),
            (gr.GATHER_INFO, gather_rows_, partseg_launches["gather_rows"],
             point_err["gather_rows"]),
            (gr.SCATTER_INFO, scatter_rows_,
             partseg_train_launches["scatter_rows"],
             point_err["scatter_rows"])):
        name = info["name"]
        kernels.append({
            **info, "launches": launches_, "max_abs_err": err_,
            **summed(rows),
            "launches_per_predict": PARTSEG_LAUNCHES_PER_PREDICT[name],
            "launches_per_train_step":
                partseg_train_launches[name] / TRAIN_STEPS,
            "calls": rows})
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
