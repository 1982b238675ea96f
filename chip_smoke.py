#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lisec_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    torchrun --nproc_per_node 4 chip_smoke.py --nccl <shared dir>
    python3 chip_smoke.py --centerpoint
    python3 chip_smoke.py --nms

The second form runs only phase 14's data-parallel checks, on NCCL with
one rank a card (four cards of one host); the third only the build, the
fused sparse conv's edge cases and phase 5's CenterPoint serving; the
fourth only the build and the NMS
rounds' kernel (``phase_nms_cells`` and ``phase_nms_grid``).

Phases, each of which fails the run (nonzero exit) when it goes wrong:

1. build every CUDA kernel of the main paths from
   ``lisec_tpu_torch/csrc`` with nvcc for sm_90a, all at once;
2. hold each kernel against its plain PyTorch version on the card, at
   the main paths' shapes plus edge cases: the fused encoder on random
   and edge-case clouds at KITTI geometry (one cell, all masked, cell
   edges, a tile denser than its shared memory holds, tile boundaries) at
   batch 4, 8 and 32, f32 and bf16, twice identical; ``segment_paint`` in its three channel
   splits and at the edges of its tiling; the unpaint source's three
   entries bit for bit (``segment_unpaint`` into f32 and bf16 at C = 4,
   6, 16, 64, 65, misaligned and on a sparse conv's cotangent gather;
   ``segment_max_backward`` with f32 and bf16-valued h full of ties;
   ``pillar_decorate`` on edge-case clouds and edge ids), and
   ``segment_max_sorted`` forward and backward (f32 inputs, and
   bf16-valued inputs full of ties);
   ``spread_accumulate`` on the rulebooks of ray-cast scenes at SECOND's
   full width (the nine convs of a batch-8 predict; the submanifold ones
   with the inverse map the encoder hands them, the strided ones also on
   scratch filled with garbage) and on edge cases, bit for bit; the
   sparse convs' fused kernel (``spread_conv``) on the same nine convs'
   own features and weights (and three in f32) and on edge cases (Cin
   4, 5 and 128, odd Cout, K 3, empty and full maps, features off 16
   bytes), against the einsum + spread pair it replaced, within one
   bf16 ulp of each landed product (``spread_conv_tolerance``); and the
   sparse conv's ``Function`` forward and backward; ``threefry`` (the
   dropout masks of the reference's threefry stream) bit-equal to its
   plain version at part seg's (16, 2048, 128) and the classifiers'
   (24 | 32, 512 | 256) mask shapes, an odd count, a slice whose flat
   index crosses 2**32 and a rank's rows, each main-path shape timed
   beside its plain version and ``torch.rand`` (``threefry_kernel``
   lines); then ``init_state(0)`` of every shipped full-width config,
   drawn on this card's host, held tensor for tensor to the SHA-256
   digests in ``tests/goldens/torch_init_digests.json``, which the CPU
   tests hold against the JAX package's draw (``init_digests`` lines);
3. drive the inference path: full-width PointPillars inference
   (``configs/pointpillars_kitti.yaml``, bf16) with the trained snapshot
   ``weights/pointpillars_fixture_hard.npz`` on 8 ray-cast scenes, with
   the launch counts set to 0 just before and read just after; check the
   outputs, and that the kernel path and the plain encoder agree; check
   the small ``pointpillars_tiny`` predict on the card against the CPU;
4. drive the training path: full-width PointPillars train steps
   (``configs/pointpillars_fixture_hard_conv.yaml``, bf16, batch 4,
   adamw + onecycle + clip) from the same snapshot on ray-cast scenes
   (2 unpaint-source launches a step: the decoration and the segment-max
   backward), the launch counts again set to 0 just before and read just
   after;
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
   way as phase 4 (10 gathers of the unpaint source a step); then
   ``build_subm_scatter_rulebook`` at SECOND's level-0 geometry (the
   voxels of 8 ray-cast scenes cut to ragged counts, V = 16,000) with
   the counts set to 0 just before a build and read just after (one
   ``segment_paint``, nothing else), equal to ``build_scatter_rulebook``,
   its paint call bit-equal to the plain version, both builders timed;
   then SECOND with ``downsample: footprint`` the same way
   (``configs/second_kitti_footprint.yaml`` at batch 8 and 1, the spread
   and the fused kernel on its nine convs, the launches as dilate's),
   every kernel
   call of a ``configs/second_footprint_conv.yaml`` train step at batch 4
   against its plain version, also with every level cut to a smaller
   budget (``FOOTPRINT_TRUNCATED``), and its train steps as phase 4's;
   then CenterPoint (``configs/centerpoint_nuscenes.yaml`` at full
   width, bf16, the benchmark cell's calibrated seed weights, ray-cast
   10-sweep frames)
   through ``infer_packed`` at batch 4 and 1 with the counts set to 0
   just before and read just after (21 fused convs, 4 of them building
   their map, and 2 paints, nothing else), every fused conv of a batch-4
   predict against the pair it replaced and timed beside its bound, that
   pair and the copy-free pair (broadcast ``matmul`` + spread), with the
   share of (tile, offset) pairs it skips; the conv's forward profiled
   (the fused kernel alone, no product, GEMM or copy); every paint call
   against its plain version;
6. time the PointPillars predict at batch 8 and 32, the SECOND predict
   (dilate and footprint) at batch 1 and 8 with its stages (and its two
   paint calls at batch 8), the three detector train steps and their parts at batch 4, and every kernel, its
   plain version and (where one exists) the PyTorch call for the same
   function at the main paths' shapes, with CUDA events;
7. PointNet++ part segmentation (``configs/pointnet2_partseg_fixture_conv
   .yaml`` at full width: SSG, 16 categories, 50 parts, 2048 points,
   seed-initialised weights, fixture clouds): ``fps`` (with the picked
   points' xyz and mask, on both of its routes), ``gather_rows`` (plain
   gathers and the fused grouping) and ``scatter_rows`` against their
   plain versions at the path's shapes and on edge cases (the scatter's
   tiling among them); ``ops.gather_points`` on (8, 16384, 3) points ->
   4,096 rows (one ``gather_rows`` launch with the counts set to 0 just
   before, bit-equal to the plain version, timed); predict through
   ``infer`` at batch 16 and 1 (2 FPS and 4 gather launches each,
   nothing else), the kernel route against the plain route;
   ``pointnet2_partseg_tiny`` on the card against the CPU; train steps
   at batch 16 (Adam, step schedule, augmentation; 3 scatter launches
   and 1 ``threefry`` a step) held against the plain route with dropout
   made the identity, a
   short ``train(cfg)``; the predict by
   stage, the train step by part, every point-kernel call (FPS beside its
   round floor: its block reductions and barriers alone); then the MSG
   network (``configs/pointnet2_shapenetpart_msg.yaml`` on the fixture:
   five groupings at radii 0.1-0.8 with up to 128 neighbours) the same
   way: predict at batch 16 and 1 (2 FPS and 7 gathers), its tiny config
   on the card against the CPU, train steps at batch 16 (4 scatters and 1
   ``threefry`` a step) against the plain route, every grouping, gather
   and scatter call of a predict and a step bit-equal to the plain
   version, and the same timings;
8. range-image segmentation (``configs/rangeseg_fixture_conv.yaml`` at
   full width: 64 x 2048 image, widths 32/64/128/256, bf16, 131,072-point
   budget, seed-initialised weights, SemanticKITTI-like scans of 16,000
   and 120,000 points): the projection's ``segment_paint`` and the kNN
   refinement's ``spread_accumulate`` (K = 1, with and without its map,
   and at the table's unpadded width) against their plain versions on
   the calls of batch-8 predicts and of edge clouds (all masked, 1,000
   points in one pixel, min-range ties, points beyond the field of
   view), bit for bit; predict through ``infer`` at batch 8 (1 paint and
   1 spread launch, nothing else), the kernel route against the plain
   route (point labels, pixel labels, the range image equal);
   ``rangeseg_tiny`` on the card against the CPU; train steps at batch 8
   (adamw, onecycle, clip 10, no augmentation, as the JAX pipeline
   trains; 1 paint a step) held against the
   plain route, a short ``train(cfg)``; the predict at batch 8 and 1 at
   both densities by stage, the train step by part, the paint and spread
   calls;
9. classification at full width on the ModelNet40 fixture: PointNet
   (``configs/pointnet_cls_fixture_conv.yaml``: both T-Nets, 1,024
   points, 40 classes, seed weights) predicts through ``infer`` at batch
   32 and 1 with every launch count 0, ``pointnet_modelnet40_tiny`` on
   the card against the CPU, train steps at batch 32 (Adam, step
   schedule, augmentation) whose first step's loss and gradients, in f32
   and in f64, are held against the same step on the CPU in f64
   (dropout the identity), a short
   ``train(cfg)`` (2 ``threefry`` launches a step, the head's masks);
   PointNet++ (``configs/pointnet2_modelnet40.yaml``:
   SSG, batch 24, augmentation with point dropout) with ``fps`` and
   ``gather_rows`` bit-equal to their plain versions on every call of
   batch-24 predicts of fixture clouds, masked tails and a ties-heavy
   cloud, predict at batch 24 and 1 (2 ``fps`` and 2 ``gather_rows``
   launches, nothing else) against the plain route, train steps (1
   ``scatter_rows`` and 2 ``threefry`` a step, checked bit-equal)
   against the plain route, a short ``train(cfg)``; then two train steps
   each of full-width part seg and PointNet++ cls with the counts set to
   0 just before and read just after (1 and 2 ``threefry`` launches a
   step), every mask the kernel drew equal to the plain version's on the
   same key, shape and offset (``stream_train_steps`` lines);
10. ``evaluate``: the trained PointPillars snapshot in
   ``configs/pointpillars_fixture_hard_conv.yaml`` through
   ``lisec_tpu_torch.evaluate`` over the whole 256-frame held-out split,
   held to the JAX package's evaluation of it on the CPU with the exact
   encoder the port computes (recall@0.5 within 0.02, each official 3D
   AP within 2.0 points, detections a frame within 5%), and read beside
   the JAX package's record of it on the TPU
   (``docs/convergence/pphard_eval.json``), whose encoder kernel routes
   each cell's max through one bf16 value; then
   ``evaluate(max_batches=2)`` of both classifiers, part and range
   segmentation and SECOND, the kernel route against the plain route;
   then each classifier's predict and train step timed, and every
   ``fps``, ``gather_rows`` and ``scatter_rows`` call of the PointNet++
   classifier;
11. the shipped detector training configs as written
   (``configs/pointpillars_fixture_hard_conv.yaml``,
   ``configs/second_fixture_conv.yaml``: full width, batch 4, their
   augmentation on: GT sampling over the 256 train scenes, per-box noise,
   flip, rotation, scale) through ``lisec_tpu_torch.train(cfg)`` with a
   checkpoint directory, only ``train.ckpt_dir``, ``train.num_steps`` and
   ``train.ckpt_every`` overridden: the launch counts set to 0 just
   before and read just after each run (3 paints and 2 unpaint-source
   launches a PointPillars step; 9 fused convs (3 building their map),
   3 paints and 10 unpaints a SECOND step), the checkpoints kept and
   ``metrics.jsonl``; resume on
   the card (two unbroken PointPillars runs, and one killed after its
   step-3 save and resumed, bit-equal in every parameter, running
   statistic and optimizer moment); the command line's ``infer`` from a
   checkpoint holding the trained snapshot's weights (one
   ``pillar_canvas_fused`` launch) equal to the pipeline's ``infer``; the
   GT database's build, one save and one restore, and ``train(cfg)``'s
   clouds/s with the augmentation on and off beside the host's batches
   alone;
12. the voxel-buffer PointPillars, the 3-class config and the int16
   wire: ``segment_paint`` bit-equal to its plain version on
   the voxel table's calls ((B, 32768, 8) rows into 12,000 x 32 slots a
   cloud) of ray-cast scenes at batch 8 and 32 and of edge clouds (a
   pillar of 500 points, more than 12,000 non-empty pillars, all
   masked); ``configs/pointpillars_kitti.yaml`` with ``fused: false``
   (full width, bf16, seed weights) through ``build_model`` and
   ``infer`` at batch 8 and 32, 1 ``segment_paint`` and no encoder
   launch a predict, the kernel route against the plain route, timed
   beside the fused model with the same weights; ``pointpillars_tiny``
   with ``fused: false`` on the card against the CPU; its train steps at
   batch 4 (``pointpillars_fixture_hard_conv.yaml``, 2 paints a step)
   against the plain route, a short ``train(cfg)``, the step timed;
   ``configs/pointpillars_kitti_3class.yaml`` at full width, predict at
   batch 8; ``infer_packed`` at batch 32 with the trained snapshot
   bit-equal to ``infer`` on the batch it dequantizes to, within the
   JAX package's wire bounds of the f32 ``infer``, the card's
   dequantization bit-equal to the CPU's, both wires' bytes and
   end-to-end ms at batch 8 and 32;
13. list under ``torch.profiler`` what ``pillar_canvas_fused``,
   ``fps_gather``, ``scatter_rows``, ``segment_paint``, ``gather_rows``,
   the grouping and ``spread_accumulate`` calls run (the outputs' and
   scratch's allocation and the kernels' own launches, nothing else;
   the paint and the spread also at the range-seg predict's shapes),
   then take the device time of every timed call of the encoder, FPS,
   the paint, the scatter, the gathers, the fused convs of a batch-8
   SECOND predict, the spreads of the range-seg predicts, and the unpaint
   source's calls of both train steps (and the plain C = 4 gather beside
   ``torch.gather``), by kernel (after the timed phases, so that no trace
   touches them);
14. data parallelism: ``infer_dp`` at world 1 bit-equal to ``infer``;
    then two gloo ranks sharing the card (``parallel.run_ranks``), held
    against one process on the same batches: full-width PointPillars
    ``infer_dp`` with the snapshot at batch 8 (keep sets exact, boxes and
    scores within phase 3's 1e-3), two DP train steps of
    ``configs/pointpillars_kitti.yaml`` at batch 8, 4 a rank (loss and
    gradient norm within 5e-4, the state by ``tests/test_dp.py``'s
    ``close_enough``; 3 paints and 2 unpaint-source launches a rank a
    step), one DP step of ``second_tiny``, ``pointnet2_partseg_tiny``,
    ``rangeseg_tiny`` and ``pointnet_modelnet40_tiny`` (every one of the
    seven kernels launched under DP), ``fps_sharded`` and
    ``ball_query_sharded`` of a 2,048-point part-seg cloud (512 picks)
    equal to the single-device FPS kernel, its plain version and the ball
    query; ``dp`` lines with the two ranks' step times beside one
    process's and the gradient bucket's all-reduce (a check of the
    program: two ranks on one card measure no speed-up);
15. print the ``{"kernels": [...]}`` line, the card's name and power
    limit, and last ``{"ok": true, "device": {...}}``.

Every comparison on the card runs with TF32 off for matrix products and
convolutions.

It needs a CUDA card and the rest of the repository; without either it
exits nonzero before printing any result.
"""

import json
import contextlib
import ctypes
import io
import os
import re
import subprocess
import sys
import tempfile
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
CENTERPOINT_CFG = os.path.join(ROOT, "configs", "centerpoint_nuscenes.yaml")
KERNEL_SOURCES = ("encoder_kernel", "segment_paint", "segment_unpaint",
                  "spread_accumulate", "fps", "gather_rows", "threefry",
                  "rotated_nms")
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
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events
    (``bench_lib.event_seconds``)."""
    from lisec_tpu_torch.bench_lib import event_seconds
    return 1e3 * event_seconds(fn, iters, warmup)


def profiled(fn, iters: int):
    """``fn()`` ``iters`` times under ``torch.profiler`` (after one call
    outside it): the aten ops the host ran and the (name, microseconds)
    of every CUDA kernel the trace caught. A trace can miss the launches
    of its first microseconds, so callers count what it caught; one that
    caught no launch at all (traces of a short loop have come back empty)
    is taken again, twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
        if kernels:
            break
    return ops, kernels


# Per-call rows whose kernel's device time the last phase fills in, with
# the call that gives it: (kernel, row, fn). Every profiler trace of the
# run comes after its timed phases.
DEVICE_TIMED = []


def kernel_label(name: str) -> str:
    """A profiler kernel name without its namespace and parameters
    (``spread_accumulate_kernel<__nv_bfloat16, 8>``); a memset keeps its
    own name."""
    m = re.search(r"(\w+)(<[^()]*>)?\(",
                  name.replace("(anonymous namespace)::", ""))
    return m.group(1) + (m.group(2) or "") if m else name


def device_parts(fn, iters: int = 20):
    """What ``fn()`` runs on the card, from a profiler trace of ``iters``
    calls: by kernel (or memset), its mean milliseconds a launch and its
    launches a call; and the sum a call, the kernels' own time without
    the host's share. A trace can miss a launch or two, so the launches a
    call are rounded from what it caught."""
    _, kernels = profiled(fn, iters)
    if not kernels:
        raise AssertionError("the profiler caught no kernel launch")
    by_name = {}
    for name, us in kernels:
        by_name.setdefault(kernel_label(name), []).append(us)
    parts = {name: {"ms": sum(v) / len(v) / 1e3,
                    "per_call": max(1, round(len(v) / iters))}
             for name, v in by_name.items()}
    return sum(p["ms"] * p["per_call"] for p in parts.values()), parts


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


ENCODER_EDGE_CASES = ("one_cell", "all_masked", "cell_edges", "dense_tile",
                      "tile_boundary")


def edge_case_clouds(b, n, geo, gen, shift=0):
    """Random clouds over (a bit more than) the range; cloud k >= 1 takes
    the edge case ``ENCODER_EDGE_CASES[(k - 1 + shift) % 5]``: all in one
    cell; all masked; exactly on cell edges; every point in the cells of
    one tile of the canvas kernel (more than its shared keys hold, one
    cell of them alone over that); 600 points in each of the last cell of
    a tile, the first of the next and the grid's last cell (a partial
    tile), the rest at random."""
    import torch
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    r, (vx, vy) = geo["pc_range"], geo["voxel_size"]
    nx, ny = geo["grid"]
    lo = torch.tensor([r[0] - 2, r[1] - 2, r[2] - 1, 0.0])
    hi = torch.tensor([r[3] + 2, r[4] + 2, r[5] + 1, 1.0])
    pts = lo + (hi - lo) * torch.rand((b, n, 4), generator=gen)
    mask = torch.rand((b, n), generator=gen) > 0.1

    def in_cells(k, cells):
        """Cloud k's first len(cells) points at random spots inside the
        given cells, valid."""
        m = len(cells)
        jitter = 0.1 + 0.8 * torch.rand((m, 2), generator=gen)
        pts[k, :m, 0] = r[0] + ((cells % nx).float() + jitter[:, 0]) * vx
        pts[k, :m, 1] = r[1] + ((cells // nx).float() + jitter[:, 1]) * vy
        pts[k, :m, 2] = r[2] + 0.5 + 2.0 * torch.rand(m, generator=gen)
        mask[k, :m] = True

    for k in range(1, b):
        case = ENCODER_EDGE_CASES[(k - 1 + shift) % len(ENCODER_EDGE_CASES)]
        if case == "one_cell":
            pts[k, :, 0] = r[0] + 100.5 * vx + 0.01 * torch.rand(
                n, generator=gen)
            pts[k, :, 1] = r[1] + 200.5 * vy + 0.01 * torch.rand(
                n, generator=gen)
            mask[k] = True
        elif case == "all_masked":
            mask[k] = False
        elif case == "cell_edges":
            ix = torch.randint(0, nx + 1, (n,), generator=gen).float()
            iy = torch.randint(0, ny + 1, (n,), generator=gen).float()
            pts[k, :, 0] = ix * vx + r[0]
            pts[k, :, 1] = iy * vy + r[1]
        elif case == "dense_tile":
            t0 = 40 * ek.TILE_CELLS
            cells = t0 + torch.randint(0, ek.TILE_CELLS, (n,), generator=gen)
            cells[torch.rand(n, generator=gen) < 0.2] = t0 + 777
            in_cells(k, cells)
        else:                  # tile_boundary: 600 points a cell, the rest
            edge = [ek.TILE_CELLS - 1, ek.TILE_CELLS, 7 * ek.TILE_CELLS - 1,
                    7 * ek.TILE_CELLS, nx * ny - 1]   # at random
            in_cells(k, torch.tensor(edge).repeat_interleave(600))
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
    """The fused encoder against its plain version at KITTI geometry on
    random and edge-case clouds (every case at batch 4, then batch 8 and
    32), f32 and bf16, and a second call identical bit for bit."""
    import torch
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    geo = kitti_geometry()
    n, c = 32768, 64
    w = (0.2 * torch.randn((9, c), generator=gen)).cuda()
    t = (0.1 * torch.randn((c,), generator=gen)).cuda()
    for b, shift in ((4, 0), (4, 3), (8, 0), (32, 1)):
        pts, mask = (a.cuda() for a in edge_case_clouds(b, n, geo, gen,
                                                         shift))
        ref = ek.pillar_canvas_fused_reference(
            pts, mask, w, t, out_dtype=torch.float32, **geo)
        cases = ["random"] + [
            ENCODER_EDGE_CASES[(k - 1 + shift) % len(ENCODER_EDGE_CASES)]
            for k in range(1, min(b, 6))]
        for dtype in (torch.float32, torch.bfloat16):
            got = ek.pillar_canvas_fused(pts, mask, w, t, out_dtype=dtype,
                                         **geo)
            torch.cuda.synchronize()
            err = check_canvas(got, ref, dtype,
                               f"pillar_canvas_fused b{b} {dtype}")
            again = ek.pillar_canvas_fused(pts, mask, w, t, out_dtype=dtype,
                                           **geo)
            if not torch.equal(got.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               again.view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32)):
                raise AssertionError(f"pillar_canvas_fused b{b} {dtype}: "
                                     "two calls differ")
            emit("kernel_check", kernel="pillar_canvas_fused",
                 dtype=str(dtype), shape=list(got.shape), clouds=cases,
                 max_abs_err=err, two_calls_identical=True,
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


# The unpaint source's entries and the kernel each launches.
UNPAINT_ENTRIES = ("segment_unpaint", "segment_max_backward",
                   "pillar_decorate")
UNPAINT_KERNELS = {"segment_unpaint": "unpaint_kernel",
                   "segment_max_backward": "segmax_backward_kernel",
                   "pillar_decorate": "decorate_kernel"}


def equal_to_plain(entry, args, kw, what):
    """One call of an unpaint-source entry on the card against its plain
    version on the same tensors, bit for bit (``torch.equal``: -0.0
    equals 0.0 there). Returns the kernel's output."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    got = getattr(su, entry)(*args, **kw)
    torch.cuda.synchronize()
    ref = getattr(su, entry + "_reference")(*args, **kw)
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(
            f"{entry} {what}: {int((got.float() != ref.float()).sum())} of "
            f"{got.numel()} elements differ from the plain version")
    return got


def check_unpaint_entries(gen):
    """The unpaint source's three entries bit-equal to their plain
    versions: the gather at C = 4, 6, 16, 64, 65 (its three unit widths)
    into f32 and bf16, on a misaligned table view and on a sparse conv's
    cotangent gather with its -1 entries; the segment-max backward at the
    train path's shape and C = 4, 16, 65 with f32 and bf16-valued h full
    of ties; the decoration on edge-case clouds at KITTI geometry (one
    cell, all masked, cell edges, dense tiles) and on ids below 0 and at
    or above the table with arbitrary stats. Every edge-id case holds ids
    below 0, ids >= R, a cloud all in one cell and a cloud all invalid
    (``edge_case_ids``)."""
    import torch
    from lisec_tpu_torch.ops import scatter
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    ids = edge_case_ids(32768, NCELLS, gen).cuda()
    for c in (4, 6, 16, 64, 65):
        table = torch.randn((4, NCELLS, c), generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            got = equal_to_plain("segment_unpaint", (table, ids),
                                 {"out_dtype": dtype}, f"C={c} {dtype}")
            if got[2].any() or not got[1].any():
                raise AssertionError("segment_unpaint: edge clouds")
        emit("kernel_check", kernel="segment_unpaint", entry="gather",
             table=list(table.shape), shape=list(got.shape),
             out_dtypes=["float32", "bfloat16"], max_abs_err=0.0,
             bit_equal=True)
    # A table view 4 bytes past an aligned start: one float a lane.
    flat = torch.randn(4 * 5000 * 64 + 1, generator=gen).cuda()
    table = flat[1:].view(4, 5000, 64)
    ids5k = edge_case_ids(32768, 5000, gen).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        equal_to_plain("segment_unpaint", (table, ids5k), {"out_dtype": dtype},
                       f"misaligned {dtype}")
    emit("kernel_check", kernel="segment_unpaint", entry="gather",
         case="misaligned_table", table=list(table.shape), max_abs_err=0.0,
         bit_equal=True)
    # A sparse conv's cotangent gather: (B, K * V_in) unsorted ids, most
    # of them -1, into a (B, V_out, Cout) table.
    v_in, v_out = 20_000, 18_000
    dz_ids = torch.randint(0, v_out, (4, 27 * v_in), generator=gen)
    dz_ids[torch.rand(dz_ids.shape, generator=gen) < 0.85] = -1
    dz_ids = dz_ids.to(torch.int32).cuda()
    for c in (16, 64):
        g = torch.randn((4, v_out, c), generator=gen).cuda()
        equal_to_plain("segment_unpaint", (g, dz_ids), {}, f"dz C={c}")
        emit("kernel_check", kernel="segment_unpaint", entry="gather",
             case="sparse_conv_dz", table=list(g.shape),
             rows=list(dz_ids.shape), max_abs_err=0.0, bit_equal=True)

    # The segment-max backward on the canvas its forward painted.
    for c in (64, 4, 16, 65):
        for name, h in (
                ("f32", torch.randn((4, 32768, c), generator=gen)),
                ("bf16_ties", (torch.randint(0, 6, (4, 32768, c),
                                             generator=gen)
                               * 0.25).bfloat16())):
            h = h.cuda()
            canvas, _ = scatter.segment_max_sorted(h, ids, NCELLS)
            g = torch.randn((4, NCELLS, c), generator=gen).cuda()
            dh = equal_to_plain("segment_max_backward", (h, ids, canvas, g),
                                {}, f"C={c} {name}")
            if dh[2].any() or not dh[1].any():
                raise AssertionError("segment_max_backward: edge clouds")
            emit("kernel_check", kernel="segment_unpaint",
                 entry="segment_max_backward", h=list(h.shape),
                 dtype=str(h.dtype), inputs=name, max_abs_err=0.0,
                 bit_equal=True,
                 rows_with_gradient=int((dh != 0).any(-1).sum()))

    # The decoration: clouds through the train path's own steps, then ids
    # the path never makes.
    geo = kitti_geometry()
    pts, mask = (a.cuda() for a in edge_case_clouds(6, 32768, geo, gen))
    cell, _, _, _ = ek.pillar_cells(pts, mask, **geo)
    cell_s, order = torch.sort(cell, dim=1, stable=True)
    pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, 4))
    ones = (cell_s < NCELLS).float()[..., None]
    stats = sp.segment_paint(torch.cat([pts_s[..., :3] * ones, ones], -1),
                             cell_s, num_cells=NCELLS, num_max=0)
    feats = equal_to_plain("pillar_decorate", (pts_s, cell_s, stats), geo,
                           "edge-case clouds")
    if feats[2].any() or not feats[1, :, 4:6].abs().max() < 0.05:
        raise AssertionError("pillar_decorate: edge clouds")
    emit("kernel_check", kernel="segment_unpaint", entry="pillar_decorate",
         case="edge_case_clouds", cases=["random", *ENCODER_EDGE_CASES],
         points=list(pts_s.shape), max_abs_err=0.0, bit_equal=True,
         valid_points=int((cell_s < NCELLS).sum()))
    stats = (torch.randn((4, NCELLS, 4), generator=gen) * 50).cuda()
    stats[..., 3] = stats[..., 3].abs().round()
    pts_r = torch.randn((4, 32768, 4), generator=gen).cuda() * 30
    equal_to_plain("pillar_decorate", (pts_r, ids, stats), geo, "edge ids")
    emit("kernel_check", kernel="segment_unpaint", entry="pillar_decorate",
         case="edge_ids", points=list(pts_r.shape), max_abs_err=0.0,
         bit_equal=True)


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

    check_unpaint_entries(gen)

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
def swapped_segment_ops(**new):
    """Swap the segment wrappers named in ``new`` (``segment_paint``,
    ``segment_unpaint``, ``segment_max_backward``, ``pillar_decorate``,
    ``spread_accumulate``, ``spread_conv``) in the modules that call them,
    here only: the package has no switch on the card."""
    from importlib import import_module
    from lisec_tpu_torch.models import pillar_encoder
    from lisec_tpu_torch.ops import range_proj, scatter, sparse_conv
    from lisec_tpu_torch.training import assigner
    # ``lisec_tpu_torch.ops`` exports functions named as these modules.
    knn_refine = import_module("lisec_tpu_torch.ops.knn_refine")
    voxelize = import_module("lisec_tpu_torch.ops.voxelize")
    saved = [(mod, name, getattr(mod, name))
             for mod in (pillar_encoder, scatter, assigner, voxelize,
                         sparse_conv, range_proj, knn_refine)
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
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    return swapped_segment_ops(
        segment_paint=sp.segment_paint_reference,
        segment_unpaint=su.segment_unpaint_reference,
        segment_max_backward=su.segment_max_backward_reference,
        pillar_decorate=su.pillar_decorate_reference,
        spread_accumulate=sa.spread_accumulate_reference,
        spread_conv=sc.spread_conv_reference)


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
    if launches != 1:
        raise AssertionError(f"the main path called pillar_canvas_fused "
                             f"{launches} times, expected 1")
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


def phase_tiny_vs_cpu(name, cfg_path, keep_sets, overrides=()):
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
                          ["model.params.score_threshold=0.0", *overrides])
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


def train_config(path, num_steps, log_every=1, overrides=()):
    """A full-width training config; the overrides are no widths. These
    phases hold single steps against the plain route, so they train
    without augmentation and save no checkpoint; phase 11 runs the
    configs as written."""
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(path), [
        "data.augment.enabled=false", 'train.ckpt_dir=""',
        f"train.num_steps={num_steps}", f"train.log_every={log_every}",
        *overrides])


def segment_launches():
    """Launches of the segment kernels, the spread, and the sparse conv's
    fused kernel (``spread_conv``) with the inverse maps it built
    (``spread_invert``)."""
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    return {"segment_paint": sp.LAUNCHES, "segment_unpaint": su.LAUNCHES,
            "spread_accumulate": sa.LAUNCHES, "spread_conv": sc.LAUNCHES,
            "spread_invert": sc.INVERT_LAUNCHES}


def zero_segment_launches():
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    sp.LAUNCHES = su.LAUNCHES = sa.LAUNCHES = 0
    sc.LAUNCHES = sc.INVERT_LAUNCHES = 0


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


def phase_train_path(name, cfg_path, weights, per_step, overrides=()):
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
    cfg = train_config(cfg_path, TRAIN_STEPS, overrides=overrides)
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
    short = train_config(cfg_path, 8, log_every=2, overrides=overrides)
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


def unpaint_bound(entry, args, kw):
    """Least ms of an unpaint-source call, by bytes (no arithmetic that
    counts): the ids and the distinct table rows this run's ids name read
    once, and for the gather its output written once; for the segment-max
    backward the canvas and cotangent rows, h read and dh written; for the
    decoration the points read and the 9-float rows written."""
    import torch
    ids = args[1]
    table = args[0] if entry == "segment_unpaint" else args[2]
    b, r, c = table.shape
    ok = (ids >= 0) & (ids < r)
    flat = ids.long() + torch.arange(b, device=ids.device)[:, None] * r
    rows_read = int(torch.unique(flat[ok]).numel())
    if entry == "segment_unpaint":
        out = kw.get("out_dtype", torch.float32)
        nbytes = (ids.nbytes + rows_read * c * 4
                  + ids.numel() * c * (2 if out == torch.bfloat16 else 4))
    elif entry == "segment_max_backward":
        nbytes = ids.nbytes + 2 * rows_read * c * 4 + 2 * args[0].nbytes
    else:
        nbytes = (ids.nbytes + args[0].nbytes + rows_read * c * 4
                  + ids.numel() * 9 * 4)
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


def spread_call_row(vals, targets, num_out, sources=None, timed=False):
    """One ``spread_accumulate`` call timed on the tensors a path handed
    it (with the inverse map where the path handed one, as for a
    submanifold conv): the kernel, its plain version, its bound, and
    ``index_add_`` as the one PyTorch call for the same function (f32
    atomics in no fixed order; it takes f32 values, so a bf16 stream's
    conversion is timed with it). ``timed``: the kernels' own time is
    taken at the end (``device_ms``)."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    b, k, n, c = vals.shape
    bound, by, nbytes, landed = spread_bound(vals, targets, num_out)
    rows = (torch.where((targets < 0) | (targets >= num_out), num_out,
                        targets).long()
            + torch.arange(b, device="cuda")[:, None, None] * (num_out + 1)
            ).reshape(-1)
    flat = vals.reshape(-1, c)

    def call():
        return sa.spread_accumulate(vals, targets, num_out=num_out,
                                    sources=sources)
    row = dict(
        vals=list(vals.shape), dtype=str(vals.dtype), num_out=num_out,
        inverse_map="given" if sources is not None else "built",
        rows_landed=landed, rows_total=b * k * n,
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: sa.spread_accumulate_reference(
            vals, targets, num_out=num_out), 3),
        library_ms=cuda_ms(lambda: torch.zeros(
            (b * (num_out + 1), c), device="cuda").index_add_(
                0, rows, flat.float()), 10),
        bound_ms=bound, bound_by=by, bytes=nbytes)
    if timed:
        DEVICE_TIMED.append(("spread_accumulate", row, call))
    return row


TENSOR_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense


def spread_conv_pair(features, weights, targets, num_out, sources=None):
    """What the sparse conv ran before the fused kernel: every offset's
    product of every padded row as an einsum (a permuted view), its copy
    into the (B, K, V_in, Cout) stream, and the spread kernel."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    z = torch.einsum("bvc,kcd->bkvd", features, weights)
    return sa.spread_accumulate(z.contiguous(), targets, num_out=num_out,
                                sources=sources)


def spread_conv_library(features, weights, targets, num_out, sources=None):
    """The copy-free pair: a broadcast ``matmul`` that writes the (B, K,
    V_in, Cout) stream in place, and the spread kernel."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    z = torch.matmul(features.unsqueeze(1), weights)
    return sa.spread_accumulate(z, targets, num_out=num_out,
                                sources=sources)


def spread_conv_tolerance(features, weights, targets, num_out):
    """Per output element, how far the fused kernel may lie from the pair
    (``spread_conv_pair``). The two round each offset's product at the
    same point and add the offsets in f32 in the same order; only the
    order inside each Cin sum differs (the tensor cores' against the
    GEMM's), which can move a bf16 rounding by one unit. So, in bf16, the
    sum over the landed products of one bf16 ulp of each, plus 2^-16 of
    the sum of their |x| |w| (a Cin-term f32 sum in two orders, and the
    running f32 sum, when products cancel); in f32, 2e-5 of the largest
    element."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    if features.dtype == torch.float32:
        pair = spread_conv_pair(features, weights, targets, num_out)
        return torch.full_like(pair, 2e-5 * float(pair.abs().max()))
    z = torch.einsum("bvc,kcd->bkvd", features, weights).float()
    _, e = torch.frexp(z)
    ulp = torch.where(z != 0, torch.ldexp(torch.ones_like(z), e - 8), 0.0)
    del z
    tol = sa.spread_accumulate(ulp.contiguous(), targets, num_out=num_out)
    del ulp
    mag = torch.einsum("bvc,kcd->bkvd", features.float().abs(),
                       weights.float().abs())
    return tol + 2.0 ** -16 * sa.spread_accumulate(
        mag.contiguous(), targets, num_out=num_out)


def check_spread_conv(what, features, weights, targets, num_out,
                      sources=None):
    """The fused kernel on one call against the pair, twice (the two runs
    bit-equal), each element within ``spread_conv_tolerance``. Returns
    its ``kernel_check`` fields."""
    import torch
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    got = sc.spread_conv(features, weights, targets, num_out=num_out,
                         sources=sources)
    again = sc.spread_conv(features, weights, targets, num_out=num_out,
                           sources=sources)
    torch.cuda.synchronize()
    pair = spread_conv_pair(features, weights, targets, num_out)
    tol = spread_conv_tolerance(features, weights, targets, num_out)
    d = (got - pair).abs()
    over = d > tol
    if over.any():
        i = int(torch.nonzero(over.flatten())[0])
        raise AssertionError(
            f"spread_conv {what}: {int(over.sum())} elements beyond the "
            f"tolerance, first {float(got.flatten()[i])} against "
            f"{float(pair.flatten()[i])}, allowed {float(tol.flatten()[i])}")
    if not torch.equal(got, again):
        raise AssertionError(f"spread_conv {what}: two runs differ")
    if not torch.isfinite(got).all():
        raise AssertionError(f"spread_conv {what}: non-finite output")
    return dict(kernel="spread_conv", case=what,
                features=list(features.shape), weights=list(weights.shape),
                dtype=str(features.dtype), num_out=num_out,
                inverse_map="given" if sources is not None else "built",
                rows_landed=int(((targets >= 0) & (targets < num_out)).sum()),
                elements_differing_from_pair=int((d > 0).sum()),
                elements=d.numel(), max_abs_diff=float(d.max()),
                largest_share_of_tolerance=float(
                    (d / tol.clamp_min(1e-38)).max()),
                two_runs_identical=True)


def spread_conv_bound(features, weights, targets, num_out, in_of, given):
    """Least ms of a fused call: by bytes, the ids it is handed read once
    (the inverse map where ``given``, else the rulebook), the landed
    input rows and the f32 table written once; by operations, the
    products of the (tile, offset) pairs of the inverse map ``in_of``
    that the kernel does not skip, at Cin and Cout rounded up to its 16
    and 8, over the bf16 tensor-core rate (f32: the f32 rate). Also the
    bound the benchmark's ``spread_accumulate_roofline`` divides: the
    rulebook, the landed rows at Cout in bf16 and the table."""
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    b, v_in, cin = features.shape
    k, _, cout = weights.shape
    landed = int(((targets >= 0) & (targets < num_out)).sum())
    nbytes = ((in_of if given else targets).nbytes
              + landed * cin * features.element_size()
              + b * num_out * cout * 4)
    live = (1.0 - sc.skipped_share(in_of)) * b * k * (
        -(-num_out // sc.TILE_ROWS))
    flops = live * 2.0 * sc.TILE_ROWS * (-(-cin // 16) * 16) * (
        -(-cout // 8) * 8)
    rate = TENSOR_FLOPS if features.element_size() == 2 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    bench = (targets.nbytes + landed * cout * 2 + b * num_out * cout * 4
             ) / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, landed, bench)


def spread_conv_call_row(features, weights, targets, num_out, sources=None,
                         timed=False):
    """One fused call timed on the tensors a path handed it: the kernel
    (``ms``; one launch, two where it builds its map), the pair it
    replaced (``pair_ms``: einsum, the stream's copy, the spread kernel),
    the copy-free pair (``library_ms``: a broadcast ``matmul`` into the
    stream, the spread kernel), the plain version, the bound, and the
    share of (tile, offset) pairs it skips. ``timed``: the kernels' own
    time is taken at the end (``device_ms``)."""
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    in_of = sources if sources is not None else inverse_map(targets,
                                                            num_out)
    bound, by, nbytes, landed, bench = spread_conv_bound(
        features, weights, targets, num_out, in_of, sources is not None)

    def call():
        return sc.spread_conv(features, weights, targets, num_out=num_out,
                              sources=sources)
    row = dict(
        features=list(features.shape), weights=list(weights.shape),
        dtype=str(features.dtype), num_out=num_out,
        inverse_map="given" if sources is not None else "built",
        rows_landed=landed, skipped_share=sc.skipped_share(in_of),
        ms=cuda_ms(call, 20),
        pair_ms=cuda_ms(lambda: spread_conv_pair(
            features, weights, targets, num_out, sources), 10),
        library_ms=cuda_ms(lambda: spread_conv_library(
            features, weights, targets, num_out, sources), 10),
        plain_ms=cuda_ms(lambda: sc.spread_conv_reference(
            features, weights, targets, num_out=num_out), 2, warmup=1),
        bound_ms=bound, bound_by=by, bytes=nbytes,
        benchmark_bound_ms=bench)
    if timed:
        row["expect_launches"] = {"spread_accumulate_kernel_mma"
                                  if features.element_size() == 2 else
                                  "spread_accumulate_kernel_fma": 1}
        if sources is None:
            row["expect_launches"]["spread_invert_kernel"] = 1
        DEVICE_TIMED.append(("spread_conv", row, call))
    return row


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


def decorate_composed(pts_s, cell_s, stats, grid, voxel_size, pc_range):
    """The decoration as the encoder composed it before it was one
    launch: the C = 4 gather kernel, then the torch ops (the route the
    decoration kernel replaces, on this tree's gather)."""
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    import torch
    nx, ny = grid
    ncells = nx * ny
    ones = (cell_s < ncells).float()[..., None]
    per_pt = su.segment_unpaint(stats, cell_s)
    mean_pt = per_pt[..., :3] / per_pt[..., 3:].clamp_min(1.0)
    cell_c = cell_s.clamp(max=ncells - 1)
    px = ((cell_c % nx).float() + 0.5) * voxel_size[0] + pc_range[0]
    py = ((cell_c // nx).float() + 0.5) * voxel_size[1] + pc_range[1]
    center = torch.stack([pts_s[..., 0] - px, pts_s[..., 1] - py], -1)
    return torch.cat([pts_s, pts_s[..., :3] - mean_pt, center], -1) * ones


def unpaint_call_row(entry, args, kw):
    """One unpaint-source call timed on the tensors a train step handed
    it, after holding it bit-equal to its plain version there: the
    wrapper (one launch; ``device_ms``, filled in at the end, its
    kernel's own time), its plain version, its bound and, for a gather
    into f32, ``torch.gather`` as the one PyTorch call for the same
    function. The segment-max backward and the decoration also time the
    route each replaces (``composed_ms``: this source's gathers and the
    torch glue around them); the decoration also times the plain C = 4
    gather of its stats table (its ``c4_gather``, kernel and
    ``torch.gather``, both with their device times); a gather also times
    a fill of its output (``write_floor_ms``)."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    equal_to_plain(entry, args, kw, "train step call")
    fn, plain = getattr(su, entry), getattr(su, entry + "_reference")
    bound, by, nbytes = unpaint_bound(entry, args, kw)

    def call():
        return fn(*args, **kw)

    def gather_index(table, ids):
        ok = (ids >= 0) & (ids < table.shape[1])
        return torch.where(ok, ids, 0).long()[..., None].expand(
            -1, -1, table.shape[2])
    row = dict(
        entry=entry, shapes=[list(a.shape) for a in args],
        dtypes=[str(a.dtype) for a in args],
        **{k: str(v) for k, v in kw.items() if k == "out_dtype"},
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: plain(*args, **kw), 5),
        library_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes,
        expect_launches={UNPAINT_KERNELS[entry]: 1})
    if entry == "segment_unpaint":
        table, ids = args
        idx = gather_index(table, ids)
        row["gather_ms"] = cuda_ms(lambda: torch.gather(table, 1, idx), 20)
        if kw.get("out_dtype", torch.float32) == torch.float32:
            row["library_ms"] = row["gather_ms"]
        # The output written alone (a fill of a tensor of its size and
        # type): a floor under any gather into it.
        out = call()
        row["write_floor_ms"] = cuda_ms(out.zero_, 20)
    elif entry == "segment_max_backward":
        h, ids, canvas, g = args
        idx = gather_index(canvas, ids)

        def composed():
            mx = su.segment_unpaint(canvas, ids)
            gp = su.segment_unpaint(g, ids)
            return torch.where(h.float() == mx, gp, 0.0).to(h.dtype)
        row["composed_ms"] = cuda_ms(composed, 20)
        row["two_gathers_ms"] = cuda_ms(lambda: (
            torch.gather(canvas, 1, idx), torch.gather(g, 1, idx)), 20)
    else:
        pts_s, ids, stats = args
        row["composed_ms"] = cuda_ms(lambda: decorate_composed(
            *args, **kw), 20)
        idx = gather_index(stats, ids)
        c4_bound = unpaint_bound("segment_unpaint", (stats, ids), {})[0]

        def c4():
            return su.segment_unpaint(stats, ids)

        def c4_library():
            return torch.gather(stats, 1, idx)
        kernel_row = dict(entry="segment_unpaint", table=list(stats.shape),
                          rows=list(ids.shape), ms=cuda_ms(c4, 20),
                          library_ms=None, bound_ms=c4_bound,
                          expect_launches={"unpaint_kernel": 1})
        library_row = dict(entry="torch.gather", table=list(stats.shape),
                           rows=list(ids.shape), ms=cuda_ms(c4_library, 20),
                           library_ms=None, bound_ms=c4_bound)
        kernel_row["library_ms"] = library_row["ms"]
        row["c4_gather"] = {"kernel": kernel_row, "torch_gather": library_row}
        DEVICE_TIMED.append(("segment_unpaint", kernel_row, c4))
        DEVICE_TIMED.append(("torch.gather", library_row, c4_library))
    DEVICE_TIMED.append(("segment_unpaint", row, call))
    return row


@contextlib.contextmanager
def recorded_segment_calls(calls):
    """Record what the paint, unpaint-source, spread and fused-conv
    wrappers are handed, by kernel, in the dict ``calls`` (values
    detached), while they run as they are. An unpaint-source call is
    recorded as (entry, args, keywords), a fused conv's as (features,
    weights, targets, num_out, sources)."""
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    for k in ("segment_paint", "segment_unpaint", "spread_accumulate",
              "spread_conv"):
        calls[k] = []

    def rec_paint(vals, ids, *, num_cells, num_max, split=None):
        calls["segment_paint"].append((vals.detach(), ids, num_cells,
                                       num_max, split))
        return sp.segment_paint(vals, ids, num_cells=num_cells,
                                num_max=num_max, split=split)

    def recorder(entry):
        fn = getattr(su, entry)

        def rec(*args, **kw):
            calls["segment_unpaint"].append(
                (entry, tuple(a.detach() for a in args), kw))
            return fn(*args, **kw)
        return rec

    def rec_spread(vals, targets, *, num_out, sources=None):
        calls["spread_accumulate"].append((vals.detach(), targets, num_out,
                                           sources))
        return sa.spread_accumulate(vals, targets, num_out=num_out,
                                    sources=sources)

    def rec_conv(features, weights, targets, *, num_out, sources=None):
        calls["spread_conv"].append((features.detach(), weights.detach(),
                                     targets, num_out, sources))
        return sc.spread_conv(features, weights, targets, num_out=num_out,
                              sources=sources)
    with swapped_segment_ops(
            segment_paint=rec_paint, spread_accumulate=rec_spread,
            spread_conv=rec_conv,
            **{e: recorder(e) for e in UNPAINT_ENTRIES}):
        yield


def phase_train_timing(name, pipe, cfg, batch):
    """The train step of config ``name`` and its parts at batch 4, and
    the kernels on the very tensors one train step hands them."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
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
    calls = {}
    with recorded_segment_calls(calls):
        loss_and_grads(pipe, batch)
    rows = {"spread_accumulate": [spread_call_row(*call) for call
                                  in calls["spread_accumulate"]],
            "spread_conv": [spread_conv_call_row(*call) for call
                            in calls["spread_conv"]]}

    rows["segment_paint"] = [paint_call_row(*call)
                             for call in calls["segment_paint"]]

    rows["segment_unpaint"] = [unpaint_call_row(*call) for call
                               in calls["segment_unpaint"]]
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

        def call(pts=pts, mask=mask):      # this batch's, when called later
            return ek.pillar_canvas_fused(pts, mask, w, t,
                                          out_dtype=enc.dtype, **geo)
        ms_enc = cuda_ms(call, 20)
        ms_plain = cuda_ms(lambda: ek.pillar_canvas_fused_reference(
            pts, mask, w, t, out_dtype=enc.dtype, **geo), 5)
        cell, ok, _, _ = ek.pillar_cells(pts, mask, **geo)
        valid = int(ok.sum())
        nonempty = int(torch.unique(
            (cell + torch.arange(b, device="cuda")[:, None] * nx * ny)[ok])
            .numel())
        bound, bound_by, nbytes = encoder_bound(
            pts, mask, w, t, canvas.numel(), canvas.element_size(), valid,
            nonempty)
        emit("predict", config="pointpillars_kitti", batch=b,
             ms_per_batch=ms, clouds_per_s=b * 1e3 / ms,
             device_resident_ms=ms_dev,
             device_resident_clouds_per_s=b * 1e3 / ms_dev,
             model_forward_ms=ms_model, backbone_head_ms=ms_net,
             decode_nms_ms=ms_dev - ms_model)
        # The card's own time to write a canvas of this size (a memset):
        # the floor the canvas kernel's stores reach at best.
        blank = torch.empty_like(canvas)
        row = dict(batch=b, ms=ms_enc, plain_ms=ms_plain, bound_ms=bound,
                   bound_by=bound_by, library_ms=None,
                   canvas_write_ms=cuda_ms(blank.zero_, 20),
                   launches_per_predict=launches, bytes=nbytes,
                   valid_points=valid, nonempty_cells=nonempty)
        emit("encoder", **row)
        # The two kernels' own times come from a profiler trace after the
        # timed phases (phase_device_times).
        DEVICE_TIMED.append(("pillar_canvas_fused", row, call))
        rows[b] = row
    return rows


# -- SECOND: the spread kernel, serving, timing -------------------------------

def recorded_sparse_convs(pipe, dev):
    """One eval forward on a device batch with a hook on every sparse
    conv: [(layer, feats, out_of, valid[, sources])] in the encoder's
    order (a submanifold conv also takes its inverse map)."""
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


def inverse_map(targets, num_out):
    """The exact inverse of a scatter rulebook, built here with torch
    alone: (B, K, num_out) int32, entry [b, k, t] the n with
    ``targets[b, k, n] == t``, else -1."""
    import torch
    b, k, n = targets.shape
    ok = (targets >= 0) & (targets < num_out)
    inv = torch.full((b, k, num_out + 1), -1, dtype=torch.int32,
                     device=targets.device)
    rows = torch.arange(n, dtype=torch.int32,
                        device=targets.device).expand(b, k, n)
    inv.scatter_(2, torch.where(ok, targets, num_out).long(),
                 torch.where(ok, rows, -1))
    return inv[..., :num_out].contiguous()


def spread_on_scratch(vals, targets, num_out, scratch):
    """The spread kernel's two-launch route (the invert, which clears
    and fills the map, then the accumulate) on scratch that the caller
    filled, straight through the library's entry point: the wrapper
    always takes fresh scratch."""
    import torch
    from lisec_tpu_torch.ops.cuda import build
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    b, k, n, c = vals.shape
    if sa._spread_fn is None:
        sa._bind()
    out = torch.empty((b, num_out, c), device="cuda")
    err = sa._spread_fn(vals.data_ptr(), targets.data_ptr(),
                        scratch.data_ptr(), out.data_ptr(), b, k, n, c,
                        num_out, vals.dtype == torch.bfloat16, False,
                        build.stream_of(vals))
    if err != 0:
        raise AssertionError(f"spread_accumulate on scratch: cudaError {err}")
    return out


# Every fused-conv check of the run, for the kernel summary.
SPCONV_CHECKS = []


def spconv_check(what, features, weights, targets, num_out, sources=None):
    """``check_spread_conv``, its line emitted and kept."""
    row = check_spread_conv(what, features, weights, targets, num_out,
                            sources)
    SPCONV_CHECKS.append(row)
    emit("kernel_check", **row)
    return row


def random_scatter_rulebook(gen, b, k, n, num_out, fill):
    """A scatter rulebook (B, K, n) int32 on the card: per (b, k) a
    random ``fill`` share of the input rows onto distinct output rows,
    the rest -1."""
    import torch
    tg = torch.full((b, k, n), -1, dtype=torch.int32)
    m = min(int(fill * n), num_out)
    for bk in range(b * k):
        rows = torch.randperm(n, generator=gen)[:m]
        tg.view(-1, n)[bk, rows] = torch.randperm(
            num_out, generator=gen)[:m].to(torch.int32)
    return tg.cuda()


def phase_spread_conv_edges(gen):
    """The fused kernel off the models' shapes: Cin 4 and 5 (a first
    conv's, padded in shared memory), Cin and Cout at 128, odd and
    narrow Cout, K 3, an empty map, every offset onto every row, a
    tile's worth of rows and fewer, features off 16 bytes, and ids
    outside the table, in bf16 and f32, each with its map given and
    built; against the pair."""
    import torch
    gen = torch.Generator().manual_seed(gen.initial_seed() + 24)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).cuda().to(dtype)
    cases = (("cin4", 2, 27, 3000, 4, 16, 2500, 0.3),
             ("cin5", 2, 27, 3000, 5, 16, 2500, 0.3),
             ("cin128_cout128", 2, 27, 1500, 128, 128, 1400, 0.3),
             ("cin64_cout128_k3", 2, 3, 2000, 64, 128, 1200, 0.6),
             ("cout10", 1, 27, 700, 16, 10, 640, 0.5),
             ("cin24_cout40", 1, 27, 700, 24, 40, 650, 0.5),
             ("one_row", 1, 27, 5, 16, 16, 1, 0.2),
             ("ragged_tile", 3, 8, 100, 32, 32, 65, 0.9),
             ("empty_map", 2, 27, 500, 16, 32, 400, 0.0),
             ("every_offset_every_row", 2, 27, 256, 32, 64, 256, 1.0))
    for what, b, k, n, cin, cout, num_out, fill in cases:
        targets = random_scatter_rulebook(gen, b, k, n, num_out, fill)
        if what == "ragged_tile":
            # Ids past the table and below -1 drop their row.
            targets[:, :, :7] = torch.tensor(
                [num_out, num_out + 3, -5, -1, 2 ** 30, -2 ** 31, 10 ** 9],
                dtype=torch.int32, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            x = randn((b, n, cin), dtype)
            w = randn((k, cin, cout), dtype) / cin ** 0.5
            spconv_check(f"edge_{what}", x, w, targets, num_out)
            spconv_check(f"edge_{what}_given_map", x, w, targets, num_out,
                         inverse_map(targets, num_out))
    # Features 2 bytes off 16: the plain row copies instead of cp.async.
    x = randn((2 * 600 * 32 + 1,), torch.bfloat16)[1:].view(2, 600, 32)
    if x.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    targets = random_scatter_rulebook(gen, 2, 27, 600, 500, 0.4)
    spconv_check("edge_features_not_16_byte_aligned", x,
                 randn((27, 32, 32), torch.bfloat16) / 32 ** 0.5, targets,
                 500)


def phase_spread_kernel_check(pipe, cfg, gen, prefix="", edges=True):
    """``spread_accumulate`` on the card against its plain version, bit
    for bit and twice: on the scatter rulebooks of ray-cast scenes at
    SECOND's full width (all nine convs of a batch-8 predict, the six
    submanifold ones with the inverse map the encoder hands them, which
    must equal the inverse built here; the three strided ones also on
    scratch filled with garbage, and one at batch 1), with ``edges`` on
    edge cases, and through the sparse conv's ``Function`` forward and
    backward. ``prefix`` starts each case's name (another config of the
    same path). Returns the largest |difference| from the plain version
    that it saw."""
    import torch
    from lisec_tpu_torch.ops import sparse_conv
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    batch, _ = scene_batch(cfg, 8)
    convs = recorded_sparse_convs(pipe, pipe.device_batch(batch))
    if len(convs) != 9 or sum(len(c) == 5 for c in convs) != 6:
        raise AssertionError(f"{len(convs)} sparse convs recorded, "
                             f"{sum(len(c) == 5 for c in convs)} with a map")
    gen = torch.Generator(device="cuda").manual_seed(gen.initial_seed())

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    worst = 0.0

    def check(what, vals, targets, num_out, sources=None, scratch=None):
        nonlocal worst
        if scratch is None:
            def run():
                return sa.spread_accumulate(vals, targets, num_out=num_out,
                                            sources=sources)
        else:
            def run():
                return spread_on_scratch(vals, targets, num_out,
                                         scratch.clone())
        got = run()
        torch.cuda.synchronize()
        ref = sa.spread_accumulate_reference(vals, targets, num_out=num_out)
        again = run()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        what = prefix + what
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
             inverse_map=("given" if sources is not None else
                          "built on garbage scratch" if scratch is not None
                          else "built"),
             rows_landed=int(landed.sum()), rows_total=targets.numel(),
             most_offsets_on_one_row=int(hits[:, :num_out].max()),
             output_rows_hit=int((hits[:, :num_out] > 0).sum()),
             bit_equal=True, two_runs_identical=True, max_abs_err=err)
        return got

    def garbage(b, k, num_out, n, kind):
        """Scratch as the allocator may hand it over: ids inside [0, N)
        that name wrong rows, or random bits."""
        if kind == "rows":
            return torch.randint(-3, n + 3, (b, k, num_out), generator=gen,
                                 device="cuda", dtype=torch.int32)
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (b, k, num_out),
                             generator=gen, device="cuda", dtype=torch.int32)

    # Every conv of the path, bf16 as the path runs it: the submanifold
    # ones with their map (equal to the inverse built here), the strided
    # ones with the map built by the kernel, fresh and on garbage scratch.
    for i, (layer, _, out_of, valid, *given) in enumerate(convs):
        b, k, n = out_of.shape
        num_out, c = valid.shape[1], layer.weight.shape[2]
        vals = randn((b, k, n, c), torch.bfloat16)
        if given:
            if not torch.equal(given[0], inverse_map(out_of, num_out)):
                raise AssertionError(f"conv {i}: the encoder's inverse map "
                                     "differs from the rulebook's inverse")
            check(f"conv{i}_subm", vals, out_of, num_out, sources=given[0])
            continue
        check(f"conv{i}_down", vals, out_of, num_out)
        for kind in ("rows", "bits"):
            check(f"conv{i}_down_garbage_{kind}", vals, out_of, num_out,
                  scratch=garbage(b, k, num_out, n, kind))
        if i == 8:
            one = out_of[:1].contiguous()
            check("conv8_down_batch1_garbage_rows", vals[:1].contiguous(),
                  one, num_out, scratch=garbage(1, k, num_out, n, "rows"))
    # f32 streams on the level-0 and level-2 submanifold and the last
    # strided conv.
    for what, i in (("level0_subm", 0), ("level2_subm", 6),
                    ("level2_down", 8)):
        layer, _, out_of, valid, *given = convs[i]
        b, k, n = out_of.shape
        check(what + "_f32", randn((b, k, n, layer.weight.shape[2]),
                                   torch.float32), out_of, valid.shape[1],
              sources=given[0] if given else None)

    if edges:
        b, k, n, num_out = 2, 27, 4096, 4096
        ident = torch.arange(n, dtype=torch.int32).expand(
            b, k, n).contiguous()
        last = torch.full((b, k, n), -1, dtype=torch.int32)
        last[:, :, 17] = num_out - 1
        for what, targets, c in (
                ("all_rows_dropped", ident + num_out, 16),
                ("all_rows_dropped_negative", ident - n, 16),
                ("every_output_hit_by_all_offsets", ident, 64),
                ("all_streams_onto_the_last_row", last, 32),
                ("one_channel", ident.flip(2).contiguous(), 1),
                ("odd_channels", ident, 5),
                ("wide_rows", ident.flip(2).contiguous(), 384)):
            targets = targets.cuda()
            for dtype in (torch.bfloat16, torch.float32):
                vals = randn((b, k, n, c), dtype)
                got = check(what, vals, targets, num_out)
                check(what + "_given_map", vals, targets, num_out,
                      sources=inverse_map(targets, num_out))
                check(what + "_garbage_rows", vals, targets, num_out,
                      scratch=garbage(b, k, num_out, n, "rows"))
                if "dropped" in what and got.any():
                    raise AssertionError(f"{what}: a dropped row landed")
                if what == "all_streams_onto_the_last_row" and (
                        got[:, :-1].any() or not got[:, -1].any()):
                    raise AssertionError(f"{what}: rows beside the last")
        # K above the 32 offsets a warp takes at a time, a table of one row,
        # a vals pointer off 16 bytes.
        tg = torch.stack([torch.randperm(600, generator=gen, device="cuda")
                          for _ in range(2 * 40)]).view(2, 40, 600)
        check("k40", randn((2, 40, 600, 16), torch.bfloat16),
              (tg - 50).to(torch.int32).contiguous(), 500)
        check("one_output_row", randn((1, 3, 4, 8), torch.float32),
              torch.tensor([[[0, -1, -1, -1], [-1, 0, -1, -1],
                             [-1, -1, -1, 0]]],
                           dtype=torch.int32, device="cuda"), 1)
        off = randn((2 * 27 * 512 * 16 + 1,), torch.bfloat16)[1:].view(
            2, 27, 512, 16)
        if off.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned case is aligned")
        check("vals_not_16_byte_aligned", off, ident[:, :, :512].cuda()
              .contiguous(), 512)

    # The fused kernel on every conv of the path, on the features and
    # weights the path hands it (bf16), the submanifold ones with their
    # map and the strided ones building theirs, against the pair it
    # replaced; three of them also in f32.
    for i, (layer, feats, out_of, valid, *given) in enumerate(convs):
        x, w = feats.to(layer.dtype).contiguous(), layer.weight.to(
            layer.dtype).contiguous()
        spconv_check(f"{prefix}conv{i}", x, w, out_of, valid.shape[1],
                     given[0] if given else None)
        if i in (0, 6, 8):
            spconv_check(f"{prefix}conv{i}_f32", x.float(), w.float(),
                         out_of, valid.shape[1], given[0] if given else None)
    if edges:
        phase_spread_conv_edges(gen)

    # The conv's Function, kernels against plain versions: the forward
    # within the fused kernel's tolerance of the pair (the plain
    # Function is the pair's plain version, bit-equal to it); the
    # backward's two products take the gathered rows, bit-equal, and are
    # held to 1e-6 of their L2 norm.
    for i in (0, 8):
        layer, feats, out_of, valid, *given = convs[i]
        g = randn((feats.shape[0], valid.shape[1], layer.weight.shape[2]),
                  torch.float32)
        outs = []
        for plain in (False, True):
            x = feats.to(layer.dtype).detach().clone().requires_grad_()
            w = layer.weight.detach().to(layer.dtype).requires_grad_()
            with torch.enable_grad(), (plain_segment_ops() if plain
                                       else contextlib.nullcontext()):
                y = sparse_conv.sparse_conv3d_spread(
                    x, out_of, w, v_out=valid.shape[1],
                    sources=given[0] if given else None)
                (y * g).sum().backward()
            torch.cuda.synchronize()
            outs.append((y.detach(), x.grad.float(), w.grad.float()))
        tol = spread_conv_tolerance(feats.to(layer.dtype).contiguous(),
                                    layer.weight.to(layer.dtype),
                                    out_of, valid.shape[1])
        if ((outs[0][0] - outs[1][0]).abs() > tol).any():
            raise AssertionError(f"{prefix}sparse conv {i}: forward "
                                 "beyond the tolerance of the plain "
                                 "Function")
        rel = [float((a - p).norm() / p.norm().clamp_min(1e-30))
               for a, p in zip(outs[0][1:], outs[1][1:])]
        if max(rel) > 1e-6:
            raise AssertionError(f"sparse conv {i}: gradients differ from "
                                 f"the plain Function by {rel}")
        emit("kernel_check", kernel="sparse_conv3d_spread",
             case=f"{prefix}conv{i}", conv=i,
             features=list(feats.shape), out_rows=valid.shape[1],
             inverse_map="given" if given else "built",
             forward="within the fused tolerance",
             forward_bit_equal=torch.equal(outs[0][0], outs[1][0]),
             grad_rel_l2=rel,
             backward_bit_equal=all(torch.equal(a, p) for a, p in
                                    zip(outs[0][1:], outs[1][1:])))
    return worst


# No sparse conv: no launch of the fused kernel, no inverse map built.
NO_SPCONV = {"spread_conv": 0, "spread_invert": 0}
# A SECOND predict or step: the nine sparse convs are one fused launch
# each, the three strided ones building their inverse map first.
SECOND_LAUNCHES_PER_PREDICT = {"segment_paint": 2, "segment_unpaint": 0,
                               "spread_accumulate": 0, "spread_conv": 9,
                               "spread_invert": 3}
SECOND_LAUNCHES_PER_TRAIN_STEP = {"segment_paint": 3, "segment_unpaint": 10,
                                  "spread_accumulate": 0, "spread_conv": 9,
                                  "spread_invert": 3}
POINTPILLARS_LAUNCHES_PER_TRAIN_STEP = {
    "segment_paint": 3, "segment_unpaint": 2, "spread_accumulate": 0,
    **NO_SPCONV}


def phase_second_serving(pipe, cfg, config="second_kitti"):
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
    one, _ = scene_batch(cfg, 1)
    zero_segment_launches()
    infer(pipe, one)
    torch.cuda.synchronize()
    if segment_launches() != SECOND_LAUNCHES_PER_PREDICT:
        raise AssertionError(f"{config} predict at batch 1 launches "
                             f"{segment_launches()}")

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
    emit("second_main_path", config=config, batch=8,
         launches=launches, launches_batch_1=launches,
         voxels_and_active_per_level=counts,
         budgets=list(enc.level_budgets),
         kept_per_cloud=out["valid"].sum(1).tolist(),
         kept_per_cloud_at_threshold_0=out_k["valid"].sum(1).tolist(),
         head_map_max_abs_diff_vs_plain=diffs,
         head_maps_bit_equal=all(torch.equal(maps_k[k], maps_p[k])
                                 for k in maps_k))
    return launches


# A CenterPoint predict: the voxelizer's paint and the densify's, and
# one fused launch a sparse conv (conv_input, 4 x 4 blocks' convs, 3
# strided convs, conv_out: 21; the submanifold ones hand their map, the
# four strided ones build theirs first), no spread of a product stream.
CENTERPOINT_LAUNCHES_PER_PREDICT = {"segment_paint": 2, "segment_unpaint": 0,
                                    "spread_accumulate": 0,
                                    "spread_conv": 21, "spread_invert": 4}


def nusc_batch(cfg, b, seed0=0):
    """``b`` ray-cast 10-sweep frames (``portbench/traffic/
    raycast_nusc10.py``, seeds seed0...), padded to the budget: points
    (b, N, 5) and mask."""
    import numpy as np
    from portbench.traffic.raycast_nusc10 import make_scene
    n = cfg.budget.max_points
    pts = np.zeros((b, n, 5), np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        p = make_scene(seed0 + i, tuple(cfg.voxel.point_cloud_range))[
            "points"][:n]
        pts[i, :len(p)] = p
        mask[i, :len(p)] = True
    return {"points": pts, "point_mask": mask}


def load_centerpoint_weights(pipe):
    """The benchmark cell's weights (``portbench/configs/
    centerpoint_nuscenes.json``): the seed draw, its head gains and its
    BatchNorms and heatmap bias calibrated in the plain reference. The
    initial draw alone, its running statistics at (0, 1), grows through
    the 16 residual convs until the sizes' ``exp`` overflows."""
    import torch
    from pathlib import Path
    from lisec_tpu_torch.config import config_to_dict
    from lisec_tpu_torch.weights import convert_flax_arrays, to_flax_arrays
    from portbench.harness.spec import load_module
    loop = load_module("loops", "serve_center")
    with open(os.path.join(ROOT, "portbench", "configs",
                           "centerpoint_nuscenes.json")) as f:
        spec = json.load(f)["weights"]
    cfg = config_to_dict(pipe.cfg)
    layout = {k: tuple(v.shape)
              for k, v in to_flax_arrays(pipe.model).items()}
    w = loop.draw_weights(layout, spec, cfg, "cuda")
    pts, counts = loop.make_pool(cfg, spec["calibrate_scenes"],
                                 spec["calibrate_clouds"],
                                 spec["weight_seed"], Path(ROOT))
    loop.calibrate(w, spec, torch.as_tensor(pts, device="cuda"),
                   torch.as_tensor(counts), cfg,
                   load_module("reference", "centerpoint"))
    pipe.model.load_state_dict(convert_flax_arrays(
        {k: v.cpu().numpy() for k, v in w.items()}, "centerpoint"))
    pipe.model.eval()


def phase_centerpoint_serving():
    """CenterPoint (``configs/centerpoint_nuscenes.yaml`` at full width,
    bf16, the benchmark cell's calibrated seed weights, ray-cast 10-sweep
    frames) through
    ``infer_packed`` at batch 4 and 1 with the launch counts set to 0 just
    before and read just after (``CENTERPOINT_LAUNCHES_PER_PREDICT``);
    every fused sparse conv of a batch-4 predict held against the pair
    it replaced (``check_spread_conv``) and timed beside its bound, that
    pair and the copy-free pair, with the share of (tile, offset) pairs
    it skips; what the conv's forward runs on the card (profiled: the
    fused kernel alone, no product or copy); every ``segment_paint``
    call held against its plain version (as ``check_paint`` holds it,
    its bits compared too); the device-resident predict at batch 4 and 1
    timed. Returns the launches of a predict."""
    import torch
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.data.wire import pack_points_q16
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    from lisec_tpu_torch.ops.sparse_conv import sparse_conv3d_spread
    cfg = load_config(CENTERPOINT_CFG)
    pipe = build_model(cfg)
    load_centerpoint_weights(pipe)
    post = len(pipe.tasks) * pipe.task_post
    launches = {}
    for b, seed0 in ((4, 0), (1, 10)):
        batch = nusc_batch(cfg, b, seed0)
        packed = pack_points_q16(batch["points"], batch["point_mask"])
        pipe.infer_packed(packed)                 # warm
        torch.cuda.synchronize()
        zero_segment_launches()
        out = pipe.infer_packed(packed)
        torch.cuda.synchronize()
        launches[b] = segment_launches()
        if launches[b] != CENTERPOINT_LAUNCHES_PER_PREDICT:
            raise AssertionError(f"centerpoint predict at batch {b} "
                                 f"launches {launches[b]}, expected "
                                 f"{CENTERPOINT_LAUNCHES_PER_PREDICT}")
        if out["boxes"].shape != (b, post, 9):
            raise AssertionError(f"centerpoint boxes "
                                 f"{tuple(out['boxes'].shape)}")
        for k in ("boxes", "scores"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"centerpoint predict: non-finite {k}")
        dev = pipe.device_batch(batch)
        ms = cuda_ms(lambda: pipe.predict(dev), 5)
        emit("centerpoint_main_path", config="centerpoint_nuscenes", batch=b,
             launches=launches[b], predict_ms=ms,
             points=batch["point_mask"].sum(1).tolist(),
             kept_per_cloud=out["valid"].sum(1).tolist())

    batch = pipe.device_batch(nusc_batch(cfg, 4))
    calls = {}
    with recorded_segment_calls(calls), torch.no_grad():
        pipe.predict(batch)
    convs, paints = calls["spread_conv"], calls["segment_paint"]
    if (len(convs), len(paints), len(calls["spread_accumulate"])) != (
            21, 2, 0):
        raise AssertionError(
            f"{len(convs)} fused convs, {len(paints)} paints, "
            f"{len(calls['spread_accumulate'])} spreads recorded, expected "
            "21, 2 and 0")
    rows = []
    for i, (x, w, targets, num_out, sources) in enumerate(convs):
        spconv_check(f"centerpoint_conv{i}", x, w, targets, num_out,
                     sources)
        rows.append(spread_conv_call_row(x, w, targets, num_out, sources))
        emit("centerpoint_kernel", kernel="spread_conv", call=i, **rows[-1])
    summed = {k: sum(r[k] for r in rows) for k in (
        "ms", "pair_ms", "library_ms", "plain_ms", "bound_ms",
        "benchmark_bound_ms")}
    tiles = [r["features"][0] * r["weights"][0]
             * -(-r["num_out"] // sc.TILE_ROWS) for r in rows]
    emit("centerpoint_spconv", calls=len(rows), **summed,
         faster_than_pair=summed["ms"] < summed["pair_ms"],
         faster_than_library=summed["ms"] < summed["library_ms"],
         skipped_share=sum(r["skipped_share"] * t
                           for r, t in zip(rows, tiles)) / sum(tiles),
         bound_share=summed["bound_ms"] / summed["ms"],
         benchmark_bound_share=summed["benchmark_bound_ms"] / summed["ms"])
    # What the conv's forward runs on the card: the fused kernel (and the
    # invert where it builds its map), no product, GEMM or copy.
    for i in (1, 5):
        x, w, targets, num_out, sources = convs[i]
        ops, kernels = profiled(lambda: sparse_conv3d_spread(
            x, targets, w, v_out=num_out, sources=sources), 5)
        names = {kernel_label(k).split("<")[0] for k, _ in kernels
                 if not k.startswith("lisec.")}
        want = {"spread_accumulate_kernel_mma"} | (
            set() if sources is not None else {"spread_invert_kernel"})
        banned = sorted({o for o in ops if o in (
            "aten::einsum", "aten::matmul", "aten::mm", "aten::bmm",
            "aten::copy_", "aten::clone")})
        if names != want or banned:
            raise AssertionError(f"centerpoint conv {i}: the forward ran "
                                 f"{sorted(names)} and {banned}")
        emit("centerpoint_spconv_profile", call=i, kernels=sorted(names),
             aten_ops=sorted(set(ops)))
    for i, (vals, ids, num_cells, num_max, _) in enumerate(paints):
        # Whole tables: a split only hands the same table over in parts.
        got = sp.segment_paint(vals, ids, num_cells=num_cells,
                               num_max=num_max)
        ref = sp.segment_paint_reference(vals, ids, num_cells=num_cells,
                                         num_max=num_max)
        err, differ = check_paint(got, ref, num_max,
                                  f"centerpoint paint {i}")
        emit("kernel_check", kernel="segment_paint",
             case=("centerpoint_voxelize", "centerpoint_densify")[i],
             vals=list(vals.shape), num_cells=num_cells,
             bit_equal=differ == 0, elements_differing=differ,
             max_abs_err=err)
    return launches[4]


# The submanifold rulebook (PR 14): one paint (the 13 inverses) a build,
# nothing else.
SUBM_LAUNCHES_PER_BUILD = {"pillar_canvas_fused": 0, "segment_paint": 1,
                           "segment_unpaint": 0, "spread_accumulate": 0,
                           **NO_SPCONV,
                           "fps": 0, "gather_rows": 0, "scatter_rows": 0,
                           "threefry": 0}


def subm_level0(pipe, cfg, b=8):
    """Level 0 of SECOND serving at full width: the voxels of ``b``
    ray-cast scenes on ``second_kitti``'s grid, cloud i cut to its first
    (i + 1) / b of the points so the counts are ragged."""
    from lisec_tpu_torch.ops.sparse_conv import SparseConvSpec
    batch, _ = scene_batch(cfg, b, seed0=700)
    n = batch["point_mask"].shape[1]
    for i in range(b):
        batch["point_mask"][i, (i + 1) * n // b:] = False
    _, coords, _, num = pipe._model_args(pipe.device_batch(batch))
    spec = SparseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1),
                          tuple(reversed(pipe.grid)))
    return coords, num.to(coords.dtype), spec


def phase_subm_rulebook(pipe, cfg):
    """``build_subm_scatter_rulebook`` at SECOND's level-0 geometry
    (1408 x 1600 x 40, V = 16,000, batch 8, ragged counts): the launch
    counts set to 0 just before a build and read just after (one
    ``segment_paint``, nothing else); the rulebook equal to
    ``build_scatter_rulebook``'s; its paint call bit-equal to
    ``segment_paint_reference`` (a ``kernel_check`` line); both builders
    timed, and the paint call with its bound, plain version and
    ``index_add_``. Returns the paint's row."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.sparse_conv import (
        build_scatter_rulebook, build_subm_scatter_rulebook)
    coords, num, spec = subm_level0(pipe, cfg)
    b, v, _ = coords.shape
    if len(set(num.tolist())) < 2 or int(num.max()) > v:
        raise AssertionError(f"subm rulebook: counts {num.tolist()} are "
                             f"not ragged within {v}")
    calls, real = [], sp.segment_paint

    def recorded(vals, ids, **kw):
        calls.append((vals, ids, kw))
        return real(vals, ids, **kw)
    sp.segment_paint = recorded
    try:
        zero_all_launches()
        got = build_subm_scatter_rulebook(coords, num, spec)
        torch.cuda.synchronize()
        launches = all_launches()
    finally:
        sp.segment_paint = real
    if launches != SUBM_LAUNCHES_PER_BUILD:
        raise AssertionError(f"subm rulebook launches {launches}, expected "
                             f"{SUBM_LAUNCHES_PER_BUILD}")
    want = build_scatter_rulebook(coords, num, coords, num, spec)
    if got.shape != (b, 27, v) or not torch.equal(got, want):
        raise AssertionError(
            f"subm rulebook: {int((got != want).sum())} entries differ "
            f"from build_scatter_rulebook")
    (vals, ids, kw), = calls
    if tuple(vals.shape) != (b * 13, v, 1) or kw != {"num_cells": v,
                                                     "num_max": 0}:
        raise AssertionError(f"subm paint call {tuple(vals.shape)} {kw}")
    out = sp.segment_paint(vals, ids, **kw)
    ref = sp.segment_paint_reference(vals, ids, **kw)
    if not torch.equal(out, ref):
        raise AssertionError(f"subm paint: {int((out != ref).sum())} "
                             f"elements differ from the plain version")
    err = float((out - ref).abs().max())
    emit("kernel_check", kernel="segment_paint", case="subm_inverse",
         rows=list(vals.shape), num_cells=v, bit_equal=True,
         max_abs_err=err)
    row = paint_call_row(vals, ids, v, 0, None)
    row["max_abs_err"] = err          # the row gets its device_ms at the end
    emit("subm_rulebook", config="second_kitti", grid=list(spec.grid_in),
         batch=b, voxels=num.tolist(), launches=launches,
         equal_to_general=True,
         subm_ms=cuda_ms(lambda: build_subm_scatter_rulebook(
             coords, num, spec), 10),
         general_ms=cuda_ms(lambda: build_scatter_rulebook(
             coords, num, coords, num, spec), 10),
         paint=row)
    return row


def phase_gather_points(gen):
    """``ops.gather_points`` on (8, 16384, 3) points -> 4,096 rows a
    cloud: the counts set to 0 just before the call and read just after
    (one ``gather_rows`` launch, nothing else), the rows bit-equal to the
    plain version (a ``kernel_check`` line), and the call timed. Returns
    its row."""
    import torch
    from lisec_tpu_torch.ops import gather_points
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    pts = torch.randn((8, 16384, 3), generator=gen).cuda()
    idx = torch.randint(0, 16384, (8, 4096), generator=gen,
                        dtype=torch.int32).cuda()
    zero_all_launches()
    got = gather_points(pts, idx)
    torch.cuda.synchronize()
    launches = all_launches()
    expected = {**SUBM_LAUNCHES_PER_BUILD, "segment_paint": 0,
                "gather_rows": 1}
    if launches != expected:
        raise AssertionError(f"gather_points launches {launches}, "
                             f"expected {expected}")
    ref = gr.gather_rows_reference(pts, idx)
    if got.shape != (8, 4096, 3) or not torch.equal(got, ref):
        raise AssertionError("gather_points differs from the plain version")
    err = float((got - ref).abs().max())
    emit("kernel_check", kernel="gather_rows", entry="gather_points",
         points=list(pts.shape), ids=list(idx.shape), bit_equal=True,
         max_abs_err=err)
    row = gather_call_row(pts, idx)
    row["max_abs_err"] = err
    emit("gather_points", launches=launches, call=row)
    return row


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


def phase_second_timing(pipe, cfg, config="second_kitti"):
    """SECOND predict at batch 1 and 8 (from host numpy, device-resident,
    by stage), every fused sparse conv (``spread_conv``) of one predict
    on the tensors the path hands it, and at batch 8 its two
    ``segment_paint`` calls. Returns the batch-8 conv and paint calls."""
    import torch
    from lisec_tpu_torch.api import infer
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
        emit("second_predict", config=config, batch=b,
             ms_per_batch=ms, clouds_per_s=b * 1e3 / ms,
             device_resident_ms=ms_dev,
             device_resident_clouds_per_s=b * 1e3 / ms_dev,
             device_resident_ms_at_threshold_0=ms_dev_nms,
             stages_ms=stages)

        calls = {}
        with recorded_segment_calls(calls), torch.no_grad():
            pipe.predict(dev)
        rows[b] = ([spread_conv_call_row(*call, timed=b == 8)
                    for call in calls["spread_conv"]],
                   [paint_call_row(*call) for call in calls["segment_paint"]]
                   if b == 8 else [])
        for kernel, per_call in zip(("spread_conv", "segment_paint"),
                                    rows[b]):
            for i, call in enumerate(per_call):
                emit("second_kernel", config=config, kernel=kernel,
                     batch=b, call=i, **call)
    if len(rows[8][1]) != SECOND_LAUNCHES_PER_PREDICT["segment_paint"]:
        raise AssertionError(f"second predict paint calls {len(rows[8][1])}")
    return rows[8]


# -- SECOND with the footprint downsample ------------------------------------

SECOND_FOOTPRINT_CFG = os.path.join(ROOT, "configs",
                                    "second_kitti_footprint.yaml")
SECOND_FOOTPRINT_TRAIN_CFG = os.path.join(ROOT, "configs",
                                          "second_footprint_conv.yaml")
# Budgets that cut every level of the footprint train fixture's first
# batch: its levels 1-3 hold about 6,100, 4,500 and 3,150 cells a cloud
# under these cuts. The shipped budgets already cut level 1 of 6 of the 8
# ray-cast scenes that the serving phases predict on.
FOOTPRINT_CUT = (5120, 4096, 2560)
FOOTPRINT_TRUNCATED = ("model.params.level_budgets="
                       f"[16000,{','.join(map(str, FOOTPRINT_CUT))}]",)


def strided_level_counts(pipe, dev):
    """Cells a cloud at each level a strided sparse conv writes (its
    output list), from an eval forward on ``dev``."""
    return [conv[3].sum(1).tolist()
            for conv in recorded_sparse_convs(pipe, dev) if len(conv) == 4]


def phase_footprint_serving(gen):
    """SECOND with ``downsample: footprint`` at full width
    (``configs/second_kitti_footprint.yaml``, seed weights): the spread
    kernel bit-equal on the nine convs of a batch-8 predict (no edge
    cases: phase 5 ran them), then serving as phase 5 holds dilate's.
    Returns (pipe, cfg, launches a predict, the spread's largest |d|)."""
    from lisec_tpu_torch.api import build_model, load_config
    cfg = load_config(SECOND_FOOTPRINT_CFG)
    pipe = build_model(cfg)
    if pipe.model.encoder.downsample != "footprint":
        raise AssertionError("second_kitti_footprint: not footprint")
    err = phase_spread_kernel_check(pipe, cfg, gen, prefix="footprint_",
                                    edges=False)
    launches = phase_second_serving(pipe, cfg, "second_kitti_footprint")
    return pipe, cfg, launches, err


def phase_footprint_kernel_check():
    """Every kernel call of one footprint SECOND train step
    (``configs/second_footprint_conv.yaml``, full width, batch 4) against
    its plain version on the very tensors the step hands it: the nine
    fused convs against the pair they replaced (``check_spread_conv``),
    the ten unpaint-source gathers bit for bit, the three paints by
    ``check_paint``; as shipped, and with ``FOOTPRINT_TRUNCATED``, where
    every level keeps exactly its budget. Returns the largest |d| by
    kernel (the fused conv's from the pair)."""
    import torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    worst = dict.fromkeys(SECOND_LAUNCHES_PER_TRAIN_STEP, 0.0)
    counts = {}
    for case, overrides in (("footprint_step", ()),
                            ("footprint_truncated_step",
                             FOOTPRINT_TRUNCATED)):
        cfg = train_config(SECOND_FOOTPRINT_TRAIN_CFG, 1,
                           overrides=overrides)
        pipe = build_model(cfg)
        pipe.init_state(cfg.train.seed)
        batch = next(make_batches(pipe.make_dataset("train"), cfg.budget,
                                  cfg.train.batch_size, shuffle=True,
                                  seed=cfg.train.seed))
        counts[case] = strided_level_counts(pipe, pipe.device_batch(batch))
        calls = {}
        with recorded_segment_calls(calls):
            loss_and_grads(pipe, batch)
        n_calls = {k: len(v) for k, v in calls.items()}
        if n_calls != {k: SECOND_LAUNCHES_PER_TRAIN_STEP[k]
                       for k in n_calls}:
            raise AssertionError(f"{case}: kernel calls {n_calls}")
        for i, (x, w, targets, num_out, sources) in enumerate(
                calls["spread_conv"]):
            row = spconv_check(f"{case}_conv{i}", x, w, targets, num_out,
                               sources)
            worst["spread_conv"] = max(worst["spread_conv"],
                                       row["max_abs_diff"])
        for i, (vals, ids, nc, num_max, _) in enumerate(
                calls["segment_paint"]):
            got = sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max)
            torch.cuda.synchronize()
            ref = sp.segment_paint_reference(vals, ids, num_cells=nc,
                                             num_max=num_max)
            err, bits = check_paint(got, ref, num_max,
                                    f"segment_paint {case} call {i}")
            worst["segment_paint"] = max(worst["segment_paint"], err)
            emit("kernel_check", kernel="segment_paint",
                 case=f"{case}_call{i}", shape=list(got.shape),
                 num_max=num_max, max_channels="bit-equal",
                 sum_max_abs_err=err, sum_elements_differing=bits)
        for i, (entry, args, kw) in enumerate(calls["segment_unpaint"]):
            equal_to_plain(entry, args, kw, f"{case} call {i}")
            emit("kernel_check", kernel="segment_unpaint", entry=entry,
                 case=f"{case}_call{i}", table=list(args[0].shape),
                 ids=list(args[1].shape), bit_equal=True, max_abs_err=0.0)
        del pipe
    cut = counts["footprint_truncated_step"]
    if any(c != budget for lv, budget in zip(cut, FOOTPRINT_CUT)
           for c in lv) or any(c <= FOOTPRINT_CUT[0]
                               for c in counts["footprint_step"][0]):
        raise AssertionError(f"footprint levels {counts}, cut to "
                             f"{FOOTPRINT_CUT}")
    emit("footprint_levels", config="second_footprint_conv", batch=4,
         cells_per_cloud_levels_1_to_3=counts["footprint_step"],
         cut_to=list(FOOTPRINT_CUT), cells_when_cut=cut)
    return worst


# -- PointNet++: the point kernels, serving, training, timing ----------------

PARTSEG_CFG = os.path.join(ROOT, "configs",
                           "pointnet2_partseg_fixture_conv.yaml")
PARTSEG_TINY_CFG = os.path.join(ROOT, "configs", "pointnet2_partseg_tiny.yaml")
# The plain gathers of a full-width predict at batch 16: (source rows, C,
# ids per cloud; the two xyz shapes are what fps_gather replaced, kept as
# checks of the C = 3 gather); its two groupings (the gather launch that
# also subtracts the centres and writes the MLP's input): (points, feature
# channels or None, centres, neighbours); and the scatters of its train
# step: (rows, C, table rows).
PARTSEG_GATHER_SHAPES = ((2048, 3, 512), (512, 3, 128), (128, 256, 1536),
                         (512, 128, 6144))
PARTSEG_GROUP_SHAPES = ((2048, None, 512, 32), (512, 128, 128, 64))
PARTSEG_SCATTER_SHAPES = ((8192, 128, 512), (1536, 256, 128),
                          (6144, 128, 512))
PARTSEG_LAUNCHES_PER_PREDICT = {
    "pillar_canvas_fused": 0, "segment_paint": 0, "segment_unpaint": 0,
    "spread_accumulate": 0, "fps": 2, "gather_rows": 4, "scatter_rows": 0,
    "threefry": 0, **NO_SPCONV}
# A train step adds the gathers' backward and the head's dropout mask.
PARTSEG_LAUNCHES_PER_TRAIN_STEP = {**PARTSEG_LAUNCHES_PER_PREDICT,
                                   "scatter_rows": 3, "threefry": 1}


def point_launches():
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.ops.cuda import threefry as tf
    return {"fps": fk.LAUNCHES, "gather_rows": gr.GATHER_LAUNCHES,
            "scatter_rows": gr.SCATTER_LAUNCHES, "threefry": tf.LAUNCHES}


def all_launches():
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    return {"pillar_canvas_fused": ek.LAUNCHES, **segment_launches(),
            **point_launches()}


def zero_all_launches():
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.ops.cuda import threefry as tf
    zero_segment_launches()
    ek.LAUNCHES = fk.LAUNCHES = tf.LAUNCHES = 0
    gr.GATHER_LAUNCHES = gr.SCATTER_LAUNCHES = 0


@contextlib.contextmanager
def swapped_point_ops(fps_gather, gather, scatter, group):
    """Swap ``fps_gather`` (as ``SetAbstraction`` calls it),
    ``gather_rows``, ``scatter_rows`` and ``group_and_decorate`` (as
    ``GatherRows`` and ``GroupAndDecorate`` call them), here only: the
    package has no switch on the card."""
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    saved = [(fk, "fps_gather", fk.fps_gather),
             (gr, "gather_rows", gr.gather_rows),
             (gr, "scatter_rows", gr.scatter_rows),
             (gr, "group_and_decorate", gr.group_and_decorate)]
    fk.fps_gather, gr.gather_rows, gr.scatter_rows = (fps_gather, gather,
                                                      scatter)
    gr.group_and_decorate = group
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_point_ops():
    """The point kernels' callers on their plain PyTorch versions."""
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    return swapped_point_ops(fk.fps_gather_reference,
                             gr.gather_rows_reference,
                             gr.scatter_rows_reference,
                             gr.group_and_decorate_reference)


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
        idx, new_xyz, new_mask = fk.fps_gather(pts, mask, m)
        torch.cuda.synchronize()
        ref = fk.fps_reference(pts, mask, m)
        for name, picks in (("fps", got), ("fps_gather", idx)):
            if not torch.equal(picks, ref):
                raise AssertionError(
                    f"{name} {what}: {int((picks != ref).sum())} picks "
                    "differ from the plain version")
        sel = ref.long()
        want_xyz = pts.gather(1, sel[..., None].expand(-1, -1, 3))
        if not torch.equal(new_xyz.view(torch.int32),
                           want_xyz.view(torch.int32)) \
                or not torch.equal(new_mask, mask.gather(1, sel)):
            raise AssertionError(f"fps_gather {what}: the picked xyz or "
                                 "mask differ from the gather of the picks")
        picked_valid = mask.gather(1, got.long())
        some = mask.any(1)
        if not picked_valid[some].all() or got[~some].any():
            raise AssertionError(f"fps {what}: a masked point was picked")
        emit("kernel_check", kernel="fps", case=what,
             points=list(pts.shape), samples=m, picks_equal=True,
             new_xyz_and_mask_bit_equal=True,
             route="registers" if pts.shape[1] <= 2048 else "shared",
             valid_points_per_cloud=mask.sum(1).tolist()[:8],
             distinct_picks_per_cloud=[len(set(r)) for r in
                                       got.tolist()][:8])
        return got

    dev = pipe.device_batch(partseg_batch(pipe, cfg, 16))
    pts, mask = dev["points"].contiguous(), dev["point_mask"]
    idx1 = check_fps("sa1_full_width", pts, mask, 512)
    check_fps("sa2_full_width", gr.gather_rows(pts, idx1),
              mask.gather(1, idx1.long()), 128)
    n = 1500                          # no multiple of the 256-thread block
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
    # The shared-memory route: N above the register route's 2,048, up to
    # the limit, with the same edge cases.
    for n in (2049, fk.MAX_POINTS):
        pts = torch.rand((4, n, 3), generator=g, device="cuda")
        mask = torch.rand((4, n), generator=g, device="cuda") > 0.1
        mask[0] = False
        pts[3] = torch.randint(-2, 3, (n, 3), generator=g,
                               device="cuda").float()
        check_fps(f"shared_route_n{n}", pts, mask, 256)

    def same_bits(a, b):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int16
        return a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))

    def check_gather(what, src, idx):
        got = gr.gather_rows(src, idx)
        torch.cuda.synchronize()
        ref = gr.gather_rows_reference(src, idx)
        if not same_bits(got, ref):
            raise AssertionError(f"gather_rows {what} {src.dtype}: "
                                 f"{int((got != ref).sum())} elements differ")
        emit("kernel_check", kernel="gather_rows", case=what,
             src=list(src.shape), ids=list(idx.shape), dtype=str(src.dtype),
             src_16_byte_aligned=src.data_ptr() % 16 == 0, bit_equal=True)

    def check_group(what, xyz, feats, centers, idx):
        got = gr.group_and_decorate(xyz, feats, centers, idx)
        torch.cuda.synchronize()
        ref = gr.group_and_decorate_reference(xyz, feats, centers, idx)
        if not same_bits(got, ref):
            raise AssertionError(f"group_and_decorate {what}: "
                                 f"{int((got != ref).sum())} elements differ")
        emit("kernel_check", kernel="gather_rows", case="group_" + what,
             xyz=list(xyz.shape), features=None if feats is None
             else list(feats.shape), centers=list(centers.shape),
             ids=list(idx.shape), bit_equal=True)

    def ids(b, m, n):                   # -3 .. n + 2: beyond both ends
        out = torch.randint(-3, n + 3, (b, m), generator=g, device="cuda",
                            dtype=torch.int32)
        edge = torch.tensor([-1, n, n - 1], dtype=torch.int32)
        out[0, :3] = edge[:m]
        return out

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for rows, c, m in PARTSEG_GATHER_SHAPES:
        idx = torch.randint(0, rows, (16, m), generator=g, device="cuda",
                            dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            check_gather("full_width", randn(16, rows, c).to(dtype), idx)
    # The groupings at the path's shapes, and their two gathers alone.
    for n, c, m, k in PARTSEG_GROUP_SHAPES:
        xyz = torch.rand((16, n, 3), generator=g, device="cuda")
        feats = None if c is None else randn(16, n, c)
        idx = torch.randint(0, n, (16, m, k), generator=g, device="cuda",
                            dtype=torch.int32)
        check_group("full_width", xyz, feats, xyz[:, :m].contiguous(), idx)
        for src in (xyz, feats):
            if src is not None:
                check_gather("full_width", src, idx.view(16, m * k))
    for c in (1, 3, 5, 64, 128, 256):
        src = randn(4, 100, c)
        idx = ids(4, 333, 100)
        for dtype in (torch.float32, torch.bfloat16):
            check_gather(f"ids_out_of_range_c{c}_m333", src.to(dtype), idx)
            check_gather(f"m1_c{c}", src.to(dtype), idx[:, :1].contiguous())
        # A source off 16 bytes (one element in): narrower units.
        for dtype in (torch.float32, torch.bfloat16):
            flat = randn(4 * 100 * c + 1).to(dtype)
            check_gather(f"src_not_16_byte_aligned_c{c}",
                         flat[1:].view(4, 100, c), idx)
        xyz = randn(4, 100, 3)
        centers = randn(4, 37, 3)
        for feats in (None, src):
            fc = "none" if feats is None else c
            check_group(f"ids_out_of_range_c{fc}", xyz, feats, centers,
                        ids(4, 37 * 9, 100).view(4, 37, 9))
            check_group(f"m1_k1_c{fc}", xyz, feats, centers[:, :1]
                        .contiguous(), ids(4, 1, 100).view(4, 1, 1))
        off = randn(4 * 100 * (c + 3) + 1)[1:]
        check_group(f"pointers_not_16_byte_aligned_c{c}",
                    off[:1200].view(4, 100, 3), off[1200:].view(4, 100, c),
                    centers, ids(4, 37 * 9, 100).view(4, 37, 9))

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


def phase_partseg_serving(pipe, cfg, config="pointnet2_partseg_fixture_conv",
                          per_predict=None):
    """Full-width PointNet++ predict at batch 16 and 1 through ``infer``:
    launches (``per_predict``; SSG's 2 FPS and 4 gathers a predict,
    nothing else), outputs, and the kernel route against the plain route
    on the card."""
    per_predict = per_predict or PARTSEG_LAUNCHES_PER_PREDICT
    import torch
    from lisec_tpu_torch.api import infer
    per_batch = {}
    for b in (16, 1):
        batch = partseg_batch(pipe, cfg, b)
        zero_all_launches()
        out = infer(pipe, batch)
        torch.cuda.synchronize()
        launches = all_launches()
        if launches != per_predict:
            raise AssertionError(f"{config} predict launches {launches}, "
                                 f"expected {per_predict}")
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
        emit("partseg_main_path", config=config,
             batch=b, launches=launches, logits_max_abs=scale,
             max_abs_diff_vs_plain=diff,
             matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
             logits_bit_equal_to_plain=bool(torch.equal(logits,
                                                        plain["logits"])),
             labels_equal_to_plain=True,
             point_accuracy_seed_weights=point_acc)
        per_batch[b] = launches
    return per_batch[16]


def phase_partseg_tiny_vs_cpu(config="pointnet2_partseg_tiny", overrides=()):
    """``pointnet2_partseg_tiny`` (seed-initialised; with ``overrides``)
    on the card against the CPU: labels equal except where the top two
    logits lie within 1e-5."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    from lisec_tpu_torch.config import apply_overrides
    cfg = apply_overrides(load_config(PARTSEG_TINY_CFG), list(overrides))
    outs = []
    for d in ("cuda", "cpu"):
        pipe = build_model(cfg, d)
        batch = partseg_batch(pipe, cfg, cfg.train.batch_size, "train")
        outs.append({k: v.cpu() for k, v in infer(pipe, batch, d).items()})
    top2 = torch.topk(outs[1]["logits"], 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    differ = outs[0]["labels"] != outs[1]["labels"]
    if (differ & ~near).any():
        raise AssertionError(f"{config} cuda vs cpu: "
                             f"{int((differ & ~near).sum())} labels differ")
    emit("tiny_vs_cpu", config=config,
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


def phase_partseg_train(path=PARTSEG_CFG, overrides=(),
                        config="pointnet2_partseg_fixture_conv",
                        per_step=None):
    """Full-width PointNet++ train steps at batch 16 (Adam, the step
    schedule, augmentation on) of the config at ``path`` through
    ``train_step``: launches (``per_step``; SSG's 2 FPS, 4 gathers, 3
    scatters and 1 ``threefry`` a step), finite loss, every tensor moved;
    the first
    step's loss and gradients against the same step over the plain
    versions, dropout made the identity for that comparison; then a short
    ``lisec_tpu_torch.train`` whose loss falls."""
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.config import apply_overrides, load_config
    from lisec_tpu_torch.data.collate import make_batches
    per_step = per_step or PARTSEG_LAUNCHES_PER_TRAIN_STEP
    cfg = apply_overrides(load_config(path), [
        *overrides, 'train.ckpt_dir=""', f"train.num_steps={TRAIN_STEPS}",
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
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{config} train launches {launches} in "
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
    emit("partseg_train_path", config=config,
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
    emit("train_vs_plain", config=config,
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
    emit("train_entry_point", config=config,
         steps=8, loss_per_logged_step={r["step"]: r["loss"]
                                        for r in history},
         acc_per_logged_step={r["step"]: r["acc"] for r in history},
         lr={r["step"]: r["lr"] for r in history})
    pipe.model.load_state_dict(start)
    return pipe, cfg, first, launches


def fps_call_row(points, mask, m):
    """One ``fps_gather`` call timed on the tensors the path handed it,
    beside ``fps`` (the picks alone), its plain version and the round
    floor (the M block reductions and barriers alone at the same block
    shape). Bound: about 10 f32
    operations per valid point per round over the f32 rate, against the
    points, mask, picks and picked rows over the memory rate."""
    from lisec_tpu_torch.ops.cuda import fps as fk
    b, n, _ = points.shape
    valid = int(mask.sum())
    nbytes = points.nbytes + mask.nbytes + b * m * (4 + 12 + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * valid * (m - 1) / F32_FLOPS * 1e3

    def call():
        return fk.fps_gather(points, mask, m)
    row = dict(
        points=list(points.shape), samples=m, valid_points=valid,
        ms=cuda_ms(call, 20),
        picks_only_ms=cuda_ms(lambda: fk.fps(points, mask, m), 20),
        plain_ms=cuda_ms(lambda: fk.fps_gather_reference(points, mask, m), 3),
        round_floor_ms=cuda_ms(lambda: fk.round_floor(b, n, m), 20),
        library_ms=None, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, operations=10 * valid * (m - 1))
    DEVICE_TIMED.append(("fps", row, call))
    return row


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

    def call():
        return gr.gather_rows(src, idx)
    row = dict(
        src=list(src.shape), ids=list(idx.shape), dtype=str(src.dtype),
        rows_read=rows_read,
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: gr.gather_rows_reference(src, idx), 5),
        library_ms=cuda_ms(lambda: torch.gather(src, 1, idx64), 20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    DEVICE_TIMED.append(("gather_rows", row, call))
    return row


def grouping_call_row(xyz, features, centers, idx):
    """One grouping launch of the path (``gather_rows.group_and_decorate``
    on the tensors the path handed it): its time, its plain version, the
    model's whole call (``ops.grouping.group_and_decorate``: reshapes, the
    ``autograd.Function``, the launch) as ``model_ms``, the torch calls it
    replaces as ``library_ms`` (two ``torch.gather``, the subtraction and
    the ``cat``; one gather and the subtraction without features), and its
    bound (the ids, the rows they name, the centres and the output over
    the memory rate)."""
    import torch
    from lisec_tpu_torch.ops import grouping
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    b, n, _ = xyz.shape
    m, k = idx.shape[1:]
    c = 0 if features is None else features.shape[2]
    ok = (idx >= 0) & (idx < n)
    flat = idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n
    rows_read = int(torch.unique(flat[ok]).numel())
    nbytes = (idx.nbytes + rows_read * (3 + c) * 4 + centers.nbytes
              + idx.numel() * (3 + c) * 4)
    rows = torch.where(ok, idx, 0).long().view(b, m * k, 1)

    def torch_calls():
        g = (torch.gather(xyz, 1, rows.expand(-1, -1, 3)).view(b, m, k, 3)
             - centers[:, :, None])
        if features is None:
            return g
        return torch.cat([g, torch.gather(features, 1, rows.expand(
            -1, -1, c)).view(b, m, k, c)], dim=-1)

    def call():
        return gr.group_and_decorate(xyz, features, centers, idx)
    row = dict(
        xyz=list(xyz.shape), features=None if features is None
        else list(features.shape), centers=list(centers.shape),
        ids=list(idx.shape), rows_read=rows_read,
        ms=cuda_ms(call, 20),
        plain_ms=cuda_ms(lambda: gr.group_and_decorate_reference(
            xyz, features, centers, idx), 5),
        model_ms=cuda_ms(lambda: grouping.group_and_decorate(
            xyz, features, centers, idx), 20),
        library_ms=cuda_ms(torch_calls, 20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes=nbytes)
    DEVICE_TIMED.append(("gather_rows", row, call))
    return row


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


def recorded_point_calls(predict, step):
    """What ``predict()`` hands ``fps_gather`` and the gather kernel (in
    launch order, each ("gather", args) or ("group", args)) and what
    ``step()`` hands ``scatter_rows``, the point kernels running as they
    are: (fps calls, gather calls, scatter calls)."""
    import torch
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    calls = {"fps": [], "gather_rows": [], "scatter_rows": []}
    fps_gather, gather = fk.fps_gather, gr.gather_rows   # before the swap
    scatter, group = gr.scatter_rows, gr.group_and_decorate

    def rec_fps(points, mask, m):
        calls["fps"].append((points, mask, m))
        return fps_gather(points, mask, m)

    def rec_gather(src, idx):
        calls["gather_rows"].append(("gather", (src.detach(), idx)))
        return gather(src, idx)

    def rec_group(xyz, features, centers, idx):
        calls["gather_rows"].append(("group", (
            xyz, None if features is None else features.detach(), centers,
            idx)))
        return group(xyz, features, centers, idx)

    def rec_scatter(vals, idx, *, num_rows):
        calls["scatter_rows"].append((vals, idx, num_rows))
        return scatter(vals, idx, num_rows=num_rows)

    with swapped_point_ops(rec_fps, rec_gather, rec_scatter, rec_group):
        with torch.no_grad():
            predict()
        predict_calls = {k: list(v) for k, v in calls.items()}
        calls["scatter_rows"].clear()
        step()
    return (predict_calls["fps"], predict_calls["gather_rows"],
            calls["scatter_rows"])


def point_kernel_rows(predict, step):
    """Each call of ``recorded_point_calls(predict, step)`` timed on the
    tensors the path handed it: (fps rows, gather rows, scatter rows)."""
    fps, gathers, scatters = recorded_point_calls(predict, step)
    row_fn = {"gather": gather_call_row, "group": grouping_call_row}
    return ([fps_call_row(*c) for c in fps],
            [row_fn[kind](*c) for kind, c in gathers],
            [scatter_call_row(*c) for c in scatters])


def partseg_stage_ms(pipe, dev, runs=5):
    """Mean ms of a device-resident predict's stages, by events around the
    model's own calls (wrapped here only): FPS (with the picked points'
    xyz and mask), ball query, grouping, the SA and global MLPs, feature
    propagation (FP3, 3-NN, interpolation, MLPs) and the head."""
    import torch
    from lisec_tpu_torch.models import pointnet2
    from lisec_tpu_torch.ops.cuda import fps as fk
    model = pipe.model
    timer = EventTimer()
    functions = [(fk, "fps_gather", "fps"),
                 (pointnet2, "ball_query", "ball_query"),
                 (pointnet2, "group_and_decorate", "grouping")]
    wrapped = [(mlp, "forward", "sa_mlps") for sa in model.sa
               for mlp in sa.mlps]
    wrapped += [(model.global_sa, "forward", "sa_mlps"),
                (model.fp3, "forward", "fp"), (model.fp[0], "forward", "fp"),
                (model.fp[1], "forward", "fp"),
                (model.head_dense, "forward", "head"),
                (model.head_bn, "forward", "head"),
                (model.head_out, "forward", "head")]
    saved = [(mod, f, getattr(mod, f)) for mod, f, _ in functions]

    def run():
        with torch.no_grad():
            pipe.predict(dev)
    run()
    run()
    try:
        for obj, attr, name in wrapped:
            setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))
        for (mod, f, fn), (_, _, name) in zip(saved, functions):
            setattr(mod, f, timer.wrap(name, fn))
        total = cuda_ms(run, iters=runs, warmup=0)
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    ms = timer.ms_per_run(runs)
    ms["rest"] = total - sum(ms.values())
    ms["predict"] = total
    return ms


def phase_partseg_timing(serve_pipe, serve_cfg, train_pipe, train_cfg,
                         train_batch, config="pointnet2_partseg_fixture_conv",
                         calls=(2, 4, 3), groupings=2):
    """PointNet++ predict at batch 16 and 1 (from host numpy,
    device-resident, by stage), the train step at batch 16 and its parts,
    and every point-kernel call of a batch-16 predict (FPS, gathers) and
    of a train step's backward (scatters) on the tensors the path hands
    it: ``calls`` of each, ``groupings`` of the gathers fused groupings.
    Returns (fps rows, gather rows, scatter rows)."""
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.training.losses import cross_entropy
    for b in (16, 1):
        batch = partseg_batch(serve_pipe, serve_cfg, b)
        ms = cuda_ms(lambda: infer(serve_pipe, batch), iters=10)
        dev = serve_pipe.device_batch(batch)
        with torch.no_grad():
            ms_dev = cuda_ms(lambda: serve_pipe.predict(dev), iters=10)
        emit("partseg_predict", config=config,
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
                                rng=pipe.step_key())
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
    emit("partseg_train_step", config=config,
         batch=b, ms_per_step=ms_step, clouds_per_s=b * 1e3 / ms_step,
         host_clock_ms_per_step=host_ms,
         host_clock_clouds_per_s=b * 1e3 / host_ms,
         **{f"{k}_ms": v for k, v in parts.items()})

    rows = point_kernel_rows(lambda: serve_pipe.predict(
        serve_pipe.device_batch(partseg_batch(serve_pipe, serve_cfg, 16))),
        lambda: partseg_loss_and_grads(pipe, train_batch))
    for kernel, per_call in zip(("fps", "gather_rows", "scatter_rows"), rows):
        for i, call in enumerate(per_call):
            emit("partseg_kernel", config=config, kernel=kernel, call=i,
                 **call)
    if [len(r) for r in rows] != list(calls) or sum(
            "centers" in r for r in rows[1]) != groupings:
        raise AssertionError(f"{config} kernel calls "
                             f"{[len(r) for r in rows]}")
    return rows


# -- PointNet++ MSG part segmentation ----------------------------------------

PARTSEG_MSG_CFG = os.path.join(ROOT, "configs",
                               "pointnet2_shapenetpart_msg.yaml")
MSG_FIXTURE = ("data.fixture=true",)        # no ShapeNetPart files here
# Five groupings (SA1 at radii 0.1, 0.2, 0.4; SA2 at 0.4, 0.8) and the two
# feature propagations' gathers a predict; a step's backward scatters for
# SA2's two groupings (SA1 groups xyz alone, which takes no gradient) and
# the two propagations.
PARTSEG_MSG_LAUNCHES_PER_PREDICT = {**PARTSEG_LAUNCHES_PER_PREDICT,
                                    "gather_rows": 7}
PARTSEG_MSG_LAUNCHES_PER_TRAIN_STEP = {**PARTSEG_MSG_LAUNCHES_PER_PREDICT,
                                       "scatter_rows": 4, "threefry": 1}


def msg_config():
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(PARTSEG_MSG_CFG), list(MSG_FIXTURE))


def phase_msg_kernel_check(serve_pipe, cfg, train_pipe, train_batch):
    """Every FPS, grouping and gather of a full-width MSG predict at batch
    16 (SA2's 0.8-radius grouping takes (16, 128, 128) ids over C = 320 +
    3) and every scatter of a train step's backward, against their plain
    versions on the very tensors the path hands them, bit for bit.
    Returns the largest |d| by kernel."""
    import torch
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    dev = serve_pipe.device_batch(partseg_batch(serve_pipe, cfg, 16))
    fps, gathers, scatters = recorded_point_calls(
        lambda: serve_pipe.predict(dev),
        lambda: partseg_loss_and_grads(train_pipe, train_batch))
    calls = {"fps": fps, "scatter_rows": scatters,
             "gather_rows": [c for kind, c in gathers if kind == "gather"],
             "group": [c for kind, c in gathers if kind == "group"]}
    n_calls = {k: len(v) for k, v in calls.items()}
    if n_calls != {"fps": 2, "gather_rows": 2, "group": 5,
                   "scatter_rows": 4}:
        raise AssertionError(f"msg kernel calls {n_calls}")
    for i, (points, mask, m) in enumerate(calls["fps"]):
        idx, new_xyz, new_mask = fk.fps_gather(points, mask, m)
        torch.cuda.synchronize()
        ref = fk.fps_gather_reference(points, mask, m)
        if not all(torch.equal(a, b) for a, b in
                   zip((idx, new_xyz, new_mask), ref)):
            raise AssertionError(f"msg fps {i} differs")
        emit("kernel_check", kernel="fps", case=f"msg_sa{i}",
             points=list(points.shape), samples=m, picks_equal=True,
             new_xyz_and_mask_bit_equal=True)

    def same_bits(a, b):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int16
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(bits), b.view(bits))
    for i, (xyz, feats, centers, idx) in enumerate(calls["group"]):
        got = gr.group_and_decorate(xyz, feats, centers, idx)
        torch.cuda.synchronize()
        ref = gr.group_and_decorate_reference(xyz, feats, centers, idx)
        if not same_bits(got, ref):
            raise AssertionError(f"msg grouping {i}: "
                                 f"{int((got != ref).sum())} elements differ")
        emit("kernel_check", kernel="gather_rows", case=f"msg_group{i}",
             xyz=list(xyz.shape), features=None if feats is None
             else list(feats.shape), centers=list(centers.shape),
             ids=list(idx.shape), bit_equal=True, max_abs_err=0.0)
    for i, (src, idx) in enumerate(calls["gather_rows"]):
        got = gr.gather_rows(src, idx)
        torch.cuda.synchronize()
        if not same_bits(got, gr.gather_rows_reference(src, idx)):
            raise AssertionError(f"msg gather {i} differs")
        emit("kernel_check", kernel="gather_rows", case=f"msg_fp_gather{i}",
             src=list(src.shape), ids=list(idx.shape), bit_equal=True,
             max_abs_err=0.0)
    worst = {"fps": 0.0, "gather_rows": 0.0, "scatter_rows": 0.0}
    for i, (vals, idx, num_rows) in enumerate(calls["scatter_rows"]):
        got = gr.scatter_rows(vals, idx, num_rows=num_rows)
        torch.cuda.synchronize()
        again = gr.scatter_rows(vals, idx, num_rows=num_rows)
        ref = gr.scatter_rows_reference(vals, idx, num_rows=num_rows)
        err = float((got - ref).abs().max())
        worst["scatter_rows"] = max(worst["scatter_rows"], err)
        if not torch.equal(got, ref) or not torch.equal(got, again):
            raise AssertionError(f"msg scatter {i}: max |d| {err}, or two "
                                 "runs differ")
        ok = (idx >= 0) & (idx < num_rows)
        runs = (idx[:, 1:] == idx[:, :-1]).float().mean()
        emit("kernel_check", kernel="scatter_rows", case=f"msg_step{i}",
             vals=list(vals.shape), num_rows=num_rows,
             rows_landed=int(ok.sum()),
             share_of_ids_repeating_the_last=float(runs), bit_equal=True,
             two_runs_identical=True, max_abs_err=err)
    return worst


# -- range segmentation: the paint and spread on new callers ----------------

RANGESEG_CFG = os.path.join(ROOT, "configs", "rangeseg_fixture_conv.yaml")
RANGESEG_TINY_CFG = os.path.join(ROOT, "configs", "rangeseg_tiny.yaml")
RANGESEG_LAUNCHES_PER_PREDICT = {
    "pillar_canvas_fused": 0, "segment_paint": 1, "segment_unpaint": 0,
    "spread_accumulate": 1, "fps": 0, "gather_rows": 0, "scatter_rows": 0,
    "threefry": 0, **NO_SPCONV}
RANGESEG_LAUNCHES_PER_TRAIN_STEP = {**RANGESEG_LAUNCHES_PER_PREDICT,
                                    "spread_accumulate": 0}
# Points a cloud: the fixture's, and about one HDL-64E scan.
RANGESEG_DENSITIES = (16000, 120000)


def rangeseg_config(num_steps=TRAIN_STEPS, log_every=1):
    """The full-width range-seg config; the overrides are no widths
    (no checkpoint is saved). The pipeline augments nothing, as the JAX
    package's does not, whatever ``data.augment`` says."""
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(RANGESEG_CFG), [
        'train.ckpt_dir=""', f"train.num_steps={num_steps}",
        f"train.log_every={log_every}"])


def semantic_batch(cfg, b, num_points=16000, seed0=40_000):
    """``b`` SemanticKITTI-like scans of ``num_points`` points (seeds
    seed0...; the fixture's held-out split at 16,000), padded."""
    from lisec_tpu_torch.data.collate import collate, pad_to_budget
    from lisec_tpu_torch.data.fixtures import make_semantic_scene
    return collate([pad_to_budget(make_semantic_scene(
        seed0 + i, num_points=num_points,
        num_classes=cfg.data.num_classes), cfg.budget) for i in range(b)])


def rangeseg_edge_batch(cfg):
    """Eight edge clouds at the full budget, two of each: every point
    masked; one pixel holding 1,000 points (far beyond the refinement's
    fill depth of 32); min-range ties (points repeated, and points of one
    range in one pixel); points beyond the field of view and on the yaw
    seam, which the projection clamps."""
    import numpy as np
    batch = semantic_batch(cfg, 8, num_points=16000, seed0=77)
    pts, mask = batch["points"], batch["point_mask"]
    rng = np.random.default_rng(11)
    mask[0:2] = False
    for b in (2, 3):
        pts[b, 100:1100] = pts[b, 50] * (1 + 1e-7 * rng.random((1000, 1)))
    for b in (4, 5):
        pts[b, 2000:6000] = pts[b, 0:4000]
        pts[b, 7000:7100, :3] = pts[b, 6900, :3]
    for b in (6, 7):
        n = 4000
        yaw = rng.choice([np.pi, -np.pi, 0.0], n)
        pitch = np.deg2rad(rng.choice([30.0, -60.0, 3.0, -25.0, 89.0], n))
        r = rng.uniform(3, 70, n)
        pts[b, :n, 0] = r * np.cos(pitch) * np.cos(yaw)
        pts[b, :n, 1] = r * np.cos(pitch) * np.sin(yaw)
        pts[b, :n, 2] = r * np.sin(pitch)
    return batch


def phase_rangeseg_kernel_check(pipe, cfg):
    """The paint and the spread at the range-seg path's shapes on the card
    against their plain versions, bit for bit and twice identical: the
    calls of a batch-8 predict at both densities and of the edge clouds;
    the spread also without its inverse map and at the table's unpadded
    width (2 S^2, 50). Returns the largest |difference| for each."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    worst = {"segment_paint": 0.0, "spread_accumulate": 0.0}
    inputs = [(f"predict_{n}_points", semantic_batch(cfg, 8, n))
              for n in RANGESEG_DENSITIES]
    inputs.append(("edge_clouds", rangeseg_edge_batch(cfg)))
    for name, batch in inputs:
        calls = {}
        with recorded_segment_calls(calls), torch.no_grad():
            pipe.predict(pipe.device_batch(batch))
        counts = {k: len(v) for k, v in calls.items()}
        if counts != {"segment_paint": 1, "segment_unpaint": 0,
                      "spread_accumulate": 1, "spread_conv": 0}:
            raise AssertionError(f"rangeseg {name}: calls {counts}")
        vals, ids, nc, num_max, split = calls["segment_paint"][0]
        got = sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max)
        again = sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max)
        ref = sp.segment_paint_reference(vals, ids, num_cells=nc,
                                         num_max=num_max)
        worst["segment_paint"] = max(worst["segment_paint"],
                                     float((got - ref).abs().max()))
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            raise AssertionError(f"segment_paint {name}: differs from the "
                                 "plain version or between two calls")
        vals, targets, n_out, sources = calls["spread_accumulate"][0]
        ref = sa.spread_accumulate_reference(vals, targets, num_out=n_out)
        raw = 2 * pipe.knn_window ** 2
        unpadded = vals[..., :raw].contiguous()
        for what, got in (
                ("given map", sa.spread_accumulate(
                    vals, targets, num_out=n_out, sources=sources)),
                ("built map", sa.spread_accumulate(vals, targets,
                                                   num_out=n_out)),
                (f"C = {raw}", torch.nn.functional.pad(sa.spread_accumulate(
                    unpadded, targets, num_out=n_out, sources=sources),
                    (0, vals.shape[-1] - raw)))):
            worst["spread_accumulate"] = max(
                worst["spread_accumulate"], float((got - ref).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"spread_accumulate {name} ({what}): differs from the "
                    "plain version by "
                    f"{float((got - ref).abs().max())}")
        emit("kernel_check", kernel="segment_paint+spread_accumulate",
             inputs=f"rangeseg {name}",
             paint_rows=list(calls["segment_paint"][0][0].shape),
             paint_rows_placed=int((ids < nc).sum()),
             spread_rows=list(vals.shape),
             spread_rows_delivered=int((targets >= 0).sum()),
             result="bit-equal, twice identical; the spread with and "
                    f"without its map and at C = {raw}")
    return worst


def rangeseg_images(pipe, batch):
    """The projection of a batch and the predict's outputs."""
    import torch
    dev = pipe.device_batch(batch)
    with torch.no_grad():
        proj = pipe._project(dev["points"], dev["point_mask"])
        out = pipe.predict(dev)
    return proj, out


def phase_rangeseg_serving(pipe, cfg):
    """Full-width range-seg predict at batch 8 through ``infer`` at both
    densities: launches (1 paint and 1 spread, nothing else), outputs,
    and the kernel route against the plain route on the card (point
    labels, pixel labels and the range image equal)."""
    import torch
    from lisec_tpu_torch.api import infer
    for n in RANGESEG_DENSITIES:
        batch = semantic_batch(cfg, 8, n)
        zero_all_launches()
        out = infer(pipe, batch)
        torch.cuda.synchronize()
        launches = all_launches()
        if launches != RANGESEG_LAUNCHES_PER_PREDICT:
            raise AssertionError(f"rangeseg predict launches {launches}, "
                                 f"expected {RANGESEG_LAUNCHES_PER_PREDICT}")
        labels, pix = out["labels"], out["pixel_labels"]
        if labels.shape != (8, cfg.budget.max_points) \
                or pix.shape != (8, pipe.height, pipe.width) \
                or labels.dtype != torch.int32 or labels.min() < 0 \
                or labels.max() >= pipe.num_classes:
            raise AssertionError(f"rangeseg outputs {tuple(labels.shape)} "
                                 f"{tuple(pix.shape)}")
        torch.backends.cudnn.deterministic = True
        proj_k, out_k = rangeseg_images(pipe, batch)
        before = all_launches()
        with plain_segment_ops():
            proj_p, out_p = rangeseg_images(pipe, batch)
        torch.backends.cudnn.deterministic = False
        if all_launches() != before:
            raise AssertionError("the plain route launched a kernel")
        for k in ("labels", "pixel_labels"):
            if not torch.equal(out_k[k], out_p[k]):
                raise AssertionError(f"rangeseg {n}: {k} differ between "
                                     "the kernel and plain routes")
        for k in proj_k._fields:
            if not torch.equal(getattr(proj_k, k), getattr(proj_p, k)):
                raise AssertionError(f"rangeseg {n}: projection {k} differs")
        mask = torch.as_tensor(batch["point_mask"], device=labels.device)
        emit("rangeseg_main_path", config="rangeseg_fixture_conv", batch=8,
             points_per_cloud=n, launches=launches,
             occupied_pixels_per_cloud=proj_k.image_mask.flatten(1).sum(
                 1).tolist(),
             refined_labels_changed=int(((out_k["labels"] != torch.gather(
                 pix.flatten(1), 1, proj_k.pixel_pix.long())) & mask).sum()),
             labels_equal_to_plain=True, range_image_equal_to_plain=True)
    return launches


def phase_rangeseg_tiny_vs_cpu():
    """``rangeseg_tiny`` (seed-initialised) on the card against the CPU:
    point labels equal but for under 0.1% of the valid points, each
    difference explained by a pixel id that moved (CUDA's ``atan2f`` is
    not the C library's) or by pixel logits whose top two lie within 1e-5
    of the largest; pixel labels equal where neither holds."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    from lisec_tpu_torch.data.collate import make_batches
    cfg = load_config(RANGESEG_TINY_CFG)
    outs, projs, logits = [], [], []
    for d in ("cuda", "cpu"):
        pipe = build_model(cfg, d)
        batch = next(make_batches(pipe.make_dataset("train"), cfg.budget,
                                  cfg.train.batch_size, shuffle=False))
        outs.append({k: v.cpu() for k, v in infer(pipe, batch, d).items()})
        dev = pipe.device_batch(batch)
        with torch.no_grad():
            proj = pipe._project(dev["points"], dev["point_mask"])
            logits.append(pipe.model(proj.image).cpu())
        projs.append(proj)
    moved = (projs[0].pixel_pix.cpu() != projs[1].pixel_pix).sum().item()
    image_differs = ~(projs[0].image.cpu() == projs[1].image).all(-1)
    top2 = torch.topk(logits[1], 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5 * logits[1].abs().max()
    pix_differ = outs[0]["pixel_labels"] != outs[1]["pixel_labels"]
    if (pix_differ & ~near & ~image_differs).any():
        raise AssertionError("rangeseg_tiny cuda vs cpu: pixel labels "
                             "differ where neither image nor logits explain")
    valid = torch.as_tensor(batch["point_mask"])
    differ = (outs[0]["labels"] != outs[1]["labels"]) & valid
    if differ.sum() >= 1e-3 * valid.sum() or (differ.any() and not (
            moved or pix_differ.any())):
        raise AssertionError(f"rangeseg_tiny cuda vs cpu: {int(differ.sum())}"
                             f" of {int(valid.sum())} point labels differ")
    emit("tiny_vs_cpu", config="rangeseg_tiny",
         point_labels_differing=int(differ.sum()), valid_points=int(
             valid.sum()), pixel_ids_moved=moved,
         pixels_whose_image_differs=int(image_differs.sum()),
         pixel_labels_differing=int(pix_differ.sum()),
         pixels_with_top_two_within_1e_5=int(near.sum()),
         logits_max_abs_diff=float((logits[0] - logits[1]).abs().max()),
         logits_max_abs=float(logits[1].abs().max()))


def rangeseg_loss_and_grads(pipe, batch):
    import torch
    pipe.model.train()
    pipe.optimizer.zero_grad()
    with torch.enable_grad():
        loss, aux = pipe.loss(pipe.device_batch(batch))
        loss.backward()
    torch.cuda.synchronize()
    return (loss.detach(), aux["acc"].detach(),
            {n: p.grad.clone() for n, p in pipe.model.named_parameters()})


def phase_rangeseg_train():
    """Full-width range-seg train steps at batch 8 (adamw, onecycle, clip
    10, no augmentation) through ``train_step``: launches (1 paint a
    step, nothing else), finite metrics, every tensor moved; the first
    step's loss (1e-5) and gradients (1e-3 of each L2 norm) against the
    plain route; then a short ``lisec_tpu_torch.train`` whose loss falls."""
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches
    cfg = rangeseg_config()
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
            for k, v in RANGESEG_LAUNCHES_PER_TRAIN_STEP.items()}
    if launches != want:
        raise AssertionError(f"rangeseg train launches {launches}, expected "
                             f"{RANGESEG_LAUNCHES_PER_TRAIN_STEP} a step")
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    for a in auxes:
        if not all(v == v and abs(v) != float("inf") for v in a.values()):
            raise AssertionError(f"rangeseg train step: non-finite {a}")
    stuck = [k for k, v in pipe.model.state_dict().items()
             if torch.equal(v, start[k]) or not torch.isfinite(v).all()]
    if stuck:
        raise AssertionError(f"rangeseg train step: unchanged or "
                             f"non-finite {stuck}")
    emit("train_path", config="rangeseg_fixture_conv",
         batch=cfg.train.batch_size, steps=TRAIN_STEPS, launches=launches,
         per_step=auxes, tensors_moved=len(start))

    torch.backends.cudnn.deterministic = True
    pipe.model.load_state_dict(start)
    loss_k, acc_k, grads_k = rangeseg_loss_and_grads(pipe, first)
    pipe.model.load_state_dict(start)
    before = all_launches()
    with plain_segment_ops():
        loss_p, acc_p, grads_p = rangeseg_loss_and_grads(pipe, first)
    torch.backends.cudnn.deterministic = False
    if all_launches() != before:
        raise AssertionError("the plain run launched a kernel")
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if rel_loss > 1e-5 or float(acc_k) != float(acc_p):
        raise AssertionError(f"rangeseg loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    worst, worst_name = 0.0, ""
    for pname, gk in grads_k.items():
        rel = float((gk - grads_p[pname]).norm()
                    / grads_p[pname].norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, pname
    if worst > 1e-3:
        raise AssertionError(f"rangeseg gradient of {worst_name}: relative "
                             f"L2 difference {worst} from the plain run")
    emit("train_vs_plain", config="rangeseg_fixture_conv",
         loss=float(loss_k), plain_loss=float(loss_p),
         loss_rel_diff=rel_loss, acc=float(acc_k), worst_grad_rel_l2=worst,
         worst_grad=worst_name, gradients=len(grads_k))

    short = rangeseg_config(8, log_every=2)
    with torch.enable_grad():
        trained, history = lisec_tpu_torch.train(short, progress=False)
    torch.cuda.synchronize()
    if len(history) != 5 or trained.step != 8 or not all(
            v == v and abs(v) != float("inf")
            for rec in history for v in rec.values()):
        raise AssertionError(f"rangeseg train(): {history}")
    if not (history[-1]["loss"] + history[-2]["loss"]) / 2 \
            < history[0]["loss"]:
        raise AssertionError(f"rangeseg train() loss did not fall: "
                             f"{[r['loss'] for r in history]}")
    emit("train_entry_point", config="rangeseg_fixture_conv", steps=8,
         loss_per_logged_step={r["step"]: r["loss"] for r in history},
         lr={r["step"]: r["lr"] for r in history})
    pipe.model.load_state_dict(start)
    return pipe, cfg, first, launches


def rangeseg_stage_ms(pipe, dev, runs=5):
    """Mean ms of a device-resident range-seg predict's stages, by events
    around the pipeline's own calls (wrapped here only): the projection
    (its paint call also on its own), the network, and the refinement's
    table, sort, delivery (its spread call also on its own), fill and
    vote; ``rest`` is the argmax, the refinement's fallback and its
    inverse permutation."""
    import torch
    from importlib import import_module
    from lisec_tpu_torch.ops import range_proj
    knn_refine = import_module("lisec_tpu_torch.ops.knn_refine")
    timer = EventTimer()
    functions = [(range_proj, "segment_paint", "projection_paint"),
                 (knn_refine, "spread_accumulate", "delivery_spread"),
                 (knn_refine, "_build_table", "table"),
                 (knn_refine, "_sort_points", "sort"),
                 (knn_refine, "_deliver_rows", "delivery"),
                 (knn_refine, "_forward_fill", "fill"),
                 (knn_refine, "_vote", "vote")]
    wrapped = [(pipe, "_project", "projection"),
               (pipe.model, "forward", "network")]
    saved = [(mod, f, getattr(mod, f)) for mod, f, _ in functions]

    def run():
        with torch.no_grad():
            pipe.predict(dev)
    run()
    run()
    try:
        for obj, attr, name in wrapped:
            setattr(obj, attr, timer.wrap(name, getattr(obj, attr)))
        for (mod, f, fn), (_, _, name) in zip(saved, functions):
            setattr(mod, f, timer.wrap(name, fn))
        total = cuda_ms(run, iters=runs, warmup=0)
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
        for mod, f, fn in saved:
            setattr(mod, f, fn)
    ms = timer.ms_per_run(runs)
    ms["rest"] = total - sum(ms[k] for k in (
        "projection", "network", "table", "sort", "delivery", "fill",
        "vote"))
    ms["predict"] = total
    return ms


def phase_rangeseg_timing(serve_pipe, cfg, train_pipe, train_batch):
    """Range-seg predict at batch 8 and 1 at both densities (from host
    numpy, device-resident, by stage), the batch-8 train step and its
    parts, and the paint and spread calls of a batch-8 predict at both
    densities and of a train step on the tensors the path hands them.
    Returns (paint rows, spread rows) of the fixture-density predict and
    the train step's paint row."""
    import torch
    from lisec_tpu_torch.api import infer
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.training.losses import cross_entropy, lovasz_softmax
    rows = {}
    for n in RANGESEG_DENSITIES:
        for b in (8, 1):
            batch = semantic_batch(cfg, b, n)
            ms = cuda_ms(lambda: infer(serve_pipe, batch), iters=10)
            dev = serve_pipe.device_batch(batch)
            with torch.no_grad():
                ms_dev = cuda_ms(lambda: serve_pipe.predict(dev), iters=10)
            emit("rangeseg_predict", config="rangeseg_fixture_conv",
                 batch=b, points_per_cloud=n, ms_per_batch=ms,
                 clouds_per_s=b * 1e3 / ms, device_resident_ms=ms_dev,
                 device_resident_clouds_per_s=b * 1e3 / ms_dev,
                 stages_ms=rangeseg_stage_ms(serve_pipe, dev))
        calls = {}
        with recorded_segment_calls(calls), torch.no_grad():
            serve_pipe.predict(serve_pipe.device_batch(semantic_batch(
                cfg, 8, n)))
        paint = paint_call_row(*calls["segment_paint"][0])
        vals, targets, n_out, sources = calls["spread_accumulate"][0]
        spread = spread_call_row(vals, targets, n_out, sources, timed=True)
        # The same call on the table's unpadded width, whose rows the
        # kernel moves one float a lane, not in 16-byte pieces.
        unpadded = vals[..., :2 * serve_pipe.knn_window ** 2].contiguous()
        spread["unpadded_ms"] = cuda_ms(lambda: sa.spread_accumulate(
            unpadded, targets, num_out=n_out, sources=sources), 20)
        spread["unpadded_bound_ms"] = spread_bound(unpadded, targets,
                                                   n_out)[0]
        for kernel, row in (("segment_paint", paint),
                            ("spread_accumulate", spread)):
            emit("rangeseg_kernel", kernel=kernel, points_per_cloud=n,
                 batch=8, **row)
        rows[n] = ([paint], [spread])

    pipe, b = train_pipe, train_pipe.cfg.train.batch_size
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
            proj = pipe._project(dev["points"], dev["point_mask"])
            logits = pipe.model(proj.image)
            ev[1].record()
            labels = pipe._label_image(proj, dev["point_labels"])
            pix_mask = proj.image_mask & (labels >= 0)
            loss = cross_entropy(logits, labels, mask=pix_mask) \
                + pipe.lovasz_weight * lovasz_softmax(
                    torch.softmax(logits, -1), labels,
                    num_classes=pipe.num_classes, mask=pix_mask)
            ev[2].record()
            loss.backward()
            ev[3].record()
            pipe.optimizer.step()
            ev[4].record()
            torch.cuda.synchronize()
            if it >= 2:
                for i, k in enumerate(parts):
                    parts[k] += ev[i].elapsed_time(ev[i + 1]) / 5
        torch.cuda.reset_peak_memory_stats()
        pipe.train_step(train_batch)
        peak = torch.cuda.max_memory_allocated()
    emit("rangeseg_train_step", config="rangeseg_fixture_conv", batch=b,
         ms_per_step=ms_step, clouds_per_s=b * 1e3 / ms_step,
         host_clock_ms_per_step=host_ms,
         host_clock_clouds_per_s=b * 1e3 / host_ms,
         peak_device_memory_gb=peak / 1e9,
         **{f"{k}_ms": v for k, v in parts.items()})
    calls = {}
    with recorded_segment_calls(calls):
        rangeseg_loss_and_grads(pipe, train_batch)
    train_paint = paint_call_row(*calls["segment_paint"][0])
    emit("rangeseg_kernel", kernel="segment_paint", train_step=True,
         batch=b, **train_paint)
    return rows[RANGESEG_DENSITIES[0]], rows[RANGESEG_DENSITIES[1]], \
        train_paint


# -- classification: PointNet and PointNet++ on ModelNet40 -------------------

POINTNET_CLS_CFG = os.path.join(ROOT, "configs",
                                "pointnet_cls_fixture_conv.yaml")
POINTNET_CLS_TINY_CFG = os.path.join(ROOT, "configs",
                                     "pointnet_modelnet40_tiny.yaml")
POINTNET2_CLS_CFG = os.path.join(ROOT, "configs", "pointnet2_modelnet40.yaml")
NO_LAUNCHES = {"pillar_canvas_fused": 0, "segment_paint": 0,
               "segment_unpaint": 0, "spread_accumulate": 0, "fps": 0,
               "gather_rows": 0, "scatter_rows": 0, "threefry": 0,
               **NO_SPCONV}
# A PointNet train step: its head's two dropout masks, nothing else.
POINTNET_LAUNCHES_PER_TRAIN_STEP = {**NO_LAUNCHES, "threefry": 2}
# A PointNet2Cls predict: each set abstraction's FPS and grouping (SA1's
# on xyz alone); no feature propagation, so no other gather. A train step
# adds SA2's grouping backward into SA1's features (xyz takes no
# gradient, so SA1's grouping has no backward).
CLS_LAUNCHES_PER_PREDICT = {**NO_LAUNCHES, "fps": 2, "gather_rows": 2}
CLS_LAUNCHES_PER_TRAIN_STEP = {**CLS_LAUNCHES_PER_PREDICT, "scatter_rows": 1,
                               "threefry": 2}
# PointNet's first f32 step on the card against the exact (f64) step: every
# gradient within this fraction of its L2 norm. On the H100 the card's
# read at most 1.2e-3 and the CPU's own f32 step up to 5.4e-3 of it
# (``pointnet_step_against_cpu``), so the card's is not held to the CPU's.
POINTNET_F32_GRAD_LIMIT = 2e-3


def cls_config(path, num_steps=TRAIN_STEPS, log_every=1):
    """A full-width classification config on the ModelNet40 fixture (the
    repository holds no ModelNet40 files); the overrides are no widths
    (no checkpoint is saved; augmentation stays on)."""
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(path), [
        "data.fixture=true", "data.fixture_size=512", 'train.ckpt_dir=""',
        f"train.num_steps={num_steps}", f"train.log_every={log_every}"])


def check_cls_outputs(out, b, num_classes, what):
    import torch
    logits, labels = out["logits"], out["labels"]
    if logits.shape != (b, num_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: logits {tuple(logits.shape)}")
    if labels.dtype != torch.int32 or labels.min() < 0 \
            or labels.max() >= num_classes:
        raise AssertionError(f"{what}: labels")


def cls_loss_and_grads(pipe, batch):
    """Train-mode ``pipe.loss`` of a batch and its gradients (on the
    pipeline's device)."""
    import torch
    pipe.model.train()
    pipe.model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss, aux = pipe.loss(pipe.device_batch(batch))
        loss.backward()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    return (loss.detach(), aux["acc"].detach(),
            {n: p.grad.clone() for n, p in pipe.model.named_parameters()})


def worst_grad(grads, ref):
    """The largest relative L2 difference of a gradient and its name."""
    worst, name = 0.0, ""
    for pname, g in grads.items():
        r = ref[pname]
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        if rel > worst:
            worst, name = rel, pname
    return worst, name


def cls_train_steps(name, pipe, cfg, per_step):
    """``TRAIN_STEPS`` train steps from ``init_state`` through
    ``train_step`` on augmented fixture batches, the launch counts set to
    0 just before and read just after; finite metrics, every tensor
    moved. Returns (first batch, starting state, launches)."""
    import torch
    from lisec_tpu_torch.data.collate import make_batches
    if not cfg.data.augment.enabled or cfg.train.schedule != "step" \
            or cfg.train.optimizer != "adam":
        raise AssertionError(f"{name}: Adam, the step schedule and "
                             "augmentation must be on")
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
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{name} train launches {launches} in "
                             f"{TRAIN_STEPS} steps, expected {want}")
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    for a in auxes:
        if not all(v == v and abs(v) != float("inf") for v in a.values()):
            raise AssertionError(f"{name} train step: non-finite {a}")
    stuck = [k for k, v in pipe.model.state_dict().items()
             if torch.equal(v, start[k])]
    if stuck or pipe.step != TRAIN_STEPS:
        raise AssertionError(f"{name} train step: unchanged {stuck}, "
                             f"step {pipe.step}")
    emit("cls_train_path", config=name, batch=cfg.train.batch_size,
         steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         per_step=auxes, tensors_moved=len(start))
    return first, start, launches


def cls_short_train(name, path):
    """``lisec_tpu_torch.train`` of 40 steps from seed initialisation: the
    mean of the last two logged losses below the first step's (the
    feature T-Net's regulariser grows over the first steps, so 8 are too
    few to see the loss fall)."""
    import torch
    import lisec_tpu_torch
    with torch.enable_grad():
        trained, history = lisec_tpu_torch.train(cls_config(path, 40, 10),
                                                 progress=False)
    torch.cuda.synchronize()
    if len(history) != 5 or trained.step != 40:
        raise AssertionError(f"{name} train(): {len(history)} records")
    if not (history[-1]["loss"] + history[-2]["loss"]) / 2 \
            < history[0]["loss"]:
        raise AssertionError(f"{name} train() loss did not fall: "
                             f"{[r['loss'] for r in history]}")
    emit("train_entry_point", config=name, steps=40,
         loss_per_logged_step={r["step"]: r["loss"] for r in history},
         acc_per_logged_step={r["step"]: r["acc"] for r in history},
         lr={r["step"]: r["lr"] for r in history})


def phase_pointnet_cls():
    """PointNet classification at full width
    (``configs/pointnet_cls_fixture_conv.yaml``: both T-Nets, 1,024
    points, 40 classes, seed weights, fixture clouds): predict through
    ``infer`` at batch 32 and 1 with every launch count 0 (PointNet runs
    no kernel); ``pointnet_modelnet40_tiny`` on the card against the CPU;
    train steps at batch 32 (Adam, step schedule, augmentation), the
    first step's loss and gradients against the same step on the CPU in
    f64 (dropout the identity); a short ``train(cfg)``. Returns (pipe, cfg,
    first train batch)."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    name = "pointnet_cls_fixture_conv"
    cfg = cls_config(POINTNET_CLS_CFG)
    pipe = build_model(cfg)                        # weights from seed 0
    if [t.k for t in pipe.model.tnets] != [3, 64] \
            or cfg.budget.max_points != 1024 or cfg.data.num_classes != 40:
        raise AssertionError(f"{name}: not the full-width network")
    for b in (cfg.train.batch_size, 1):
        batch = partseg_batch(pipe, cfg, b)
        zero_all_launches()
        out = infer(pipe, batch)
        torch.cuda.synchronize()
        launches = all_launches()
        if launches != NO_LAUNCHES:
            raise AssertionError(f"{name} predict launched {launches}")
        check_cls_outputs(out, b, cfg.data.num_classes, name)
        emit("cls_main_path", config=name, batch=b, launches=launches,
             logits_max_abs=float(out["logits"].abs().max()),
             accuracy_seed_weights=float(
                 (out["labels"].cpu().numpy() == batch["label"]).mean()))

    # pointnet_modelnet40_tiny (seed-initialised) on the card against the
    # CPU: logits to 1e-4 of the largest, labels equal.
    tiny = load_config(POINTNET_CLS_TINY_CFG)
    outs = []
    for d in ("cuda", "cpu"):
        p = build_model(tiny, d)
        batch = partseg_batch(p, tiny, tiny.train.batch_size, "train")
        outs.append({k: v.cpu() for k, v in infer(p, batch, d).items()})
    diff = float((outs[0]["logits"] - outs[1]["logits"]).abs().max())
    scale = float(outs[1]["logits"].abs().max())
    if diff > 1e-4 * scale or not torch.equal(outs[0]["labels"],
                                              outs[1]["labels"]):
        raise AssertionError(f"pointnet_modelnet40_tiny cuda vs cpu: logits "
                             f"{diff} (largest {scale}) or labels differ")
    emit("tiny_vs_cpu", config="pointnet_modelnet40_tiny",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         logits_max_abs_diff=diff, logits_max_abs=scale, labels_equal=True)

    first, start, _ = cls_train_steps(name, pipe, cfg,
                                      POINTNET_LAUNCHES_PER_TRAIN_STEP)
    # The first step against the exact one (the CPU's in f64): in f64 the
    # loss within 1e-5 relative and every gradient within 1e-3 of its L2
    # norm; in f32 the loss within 1e-5 of the CPU's f32 loss, every
    # gradient within POINTNET_F32_GRAD_LIMIT of the exact one, and the
    # gradients that are 0 in exact arithmetic under 1e-5 of the global
    # norm.
    report = pointnet_step_against_cpu(pipe, cfg, first, start)
    emit("train_vs_cpu", config=name, dropout="identity",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, **report)
    f32, f64 = report["float32"], report["float64"]
    if f64["card_loss_rel_diff"] > 1e-5 or f64["card_worst_rel_l2"] > 1e-3 \
            or f32["card_loss_rel_diff"] > 1e-5 \
            or f32["card_worst_rel_l2"] > POINTNET_F32_GRAD_LIMIT \
            or max(f32["card_zero_in_exact_arithmetic"].values()) > 1e-5:
        raise AssertionError(f"{name} card vs cpu: {report}")
    cls_short_train(name, POINTNET_CLS_CFG)
    pipe.model.load_state_dict(start)
    return pipe, cfg, first


def pointnet_step_against_cpu(pipe, cfg, first, start):
    """The first train step (dropout the identity) on the card and on the
    CPU, in f32 (the path the steps run) and in f64, each gradient read
    against the CPU's f64 step, the exact one. In f32 the layers before
    the global max-pool hold gradients that are small sums of large
    terms (a train-mode BN's backward over 32,768 rows, whose terms
    cancel), so each device's f32 step sits some way from the exact one
    and the two from each other: the CPU's own f32 step is read beside
    the card's as that witness. A tensor whose f64 norm is under
    1e-9 of the global norm has no gradient in exact arithmetic (the
    T-Nets' at their identity start; the global feature's last BN bias,
    whose every path runs into the head's train-mode BN): its norm over
    the global norm is read instead."""
    import numpy as np
    import torch
    from lisec_tpu_torch.api import build_model
    cpu = build_model(cfg, "cpu")
    rate = pipe.model.head.dropout_rate
    pipe.model.head.dropout_rate = cpu.model.head.dropout_rate = 0.0
    steps = {}
    for dtype in (torch.float32, torch.float64):
        batch = {**first, "points": first["points"].astype(
            np.float64 if dtype == torch.float64 else np.float32)}
        for p in (pipe, cpu):
            p.model.load_state_dict({k: v.to(p.device)
                                     for k, v in start.items()})
            p.model.to(dtype)
        steps[dtype] = [cls_loss_and_grads(p, batch) for p in (pipe, cpu)]
        for p in (pipe, cpu):
            p.model.float()
    pipe.model.head.dropout_rate = rate
    pipe.model.load_state_dict(start)
    loss64, _, exact = steps[torch.float64][1]
    total = float(torch.sqrt(sum((g ** 2).sum() for g in exact.values())))
    report = {"gradients": len(exact), "global_norm": total,
              "cpu_f64_loss": float(loss64)}
    for dtype, ((loss_k, acc_k, grads_k), (loss_c, acc_c, grads_c)) in \
            steps.items():
        rel = {"card": {}, "cpu": {}}
        zero = {"card": {}, "cpu": {}}
        for k, ref in exact.items():
            for dev, g in (("card", grads_k[k]), ("cpu", grads_c[k])):
                g = g.cpu().double()
                if float(ref.norm()) < 1e-9 * total:
                    zero[dev][k] = float(g.norm()) / total
                else:
                    rel[dev][k] = float((g - ref).norm() / ref.norm())
        row = {"card_loss": float(loss_k), "cpu_loss": float(loss_c),
               "card_loss_rel_diff": abs(float(loss_k) / float(loss_c) - 1),
               "card_acc": float(acc_k), "cpu_acc": float(acc_c)}
        for dev in ("card", "cpu"):
            worst = max(rel[dev], key=rel[dev].get)
            row.update({
                f"{dev}_worst_grad": worst,
                f"{dev}_worst_rel_l2": rel[dev][worst],
                f"{dev}_above_1e_3": {k: v for k, v in rel[dev].items()
                                      if v > 1e-3},
                f"{dev}_zero_in_exact_arithmetic": zero[dev]})
        if dtype == torch.float32:
            row["card_vs_cpu_rel_l2"] = {
                k: float((grads_k[k].cpu() - grads_c[k]).norm()
                         / grads_c[k].norm().clamp_min(1e-30))
                for k in rel["card"]}
        report[str(dtype).split(".")[1]] = row
    return report


def checked_point_ops(worst, case):
    """The point kernels' callers on wrappers that run each kernel and its
    plain version on the same call and raise unless they agree to the bit
    (FPS: picks, picked xyz and mask; the groupings and gathers; the
    scatter), each call a ``kernel_check`` line."""
    import torch
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    fps_gather, gather = fk.fps_gather, gr.gather_rows
    scatter, group = gr.scatter_rows, gr.group_and_decorate

    def same(got, ref):
        if isinstance(got, tuple):
            return all(same(a, b) for a, b in zip(got, ref))
        if got.dtype == torch.float32:
            got, ref = got.view(torch.int32), ref.view(torch.int32)
        return got.shape == ref.shape and torch.equal(got, ref)

    def checked(kernel, fn, plain, shapes):
        def call(*args, **kw):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            ref = plain(*args, **kw)
            if not same(got, ref):
                raise AssertionError(f"{kernel} {case} "
                                     f"{shapes(*args, **kw)}: differs from "
                                     "the plain version")
            if kernel == "scatter_rows":
                worst["scatter_rows"] = max(worst["scatter_rows"], float(
                    (got - ref).abs().max()))
            emit("kernel_check", kernel=kernel, case=f"cls_{case}",
                 call=shapes(*args, **kw), bit_equal=True)
            return got
        return call

    return swapped_point_ops(
        checked("fps", fps_gather, fk.fps_gather_reference,
                lambda p, m, k: {"points": list(p.shape), "samples": k,
                                 "valid_points_per_cloud":
                                     m.sum(1).tolist()[:8]}),
        checked("gather_rows", gather, gr.gather_rows_reference,
                lambda s, i: {"src": list(s.shape), "ids": list(i.shape)}),
        checked("scatter_rows", scatter, gr.scatter_rows_reference,
                lambda v, i, num_rows: {"vals": list(v.shape),
                                        "num_rows": num_rows}),
        checked("gather_rows", group, gr.group_and_decorate_reference,
                lambda x, f, c, i: {"xyz": list(x.shape), "features":
                                    None if f is None else list(f.shape),
                                    "ids": list(i.shape)}))


def phase_pointnet2_cls():
    """PointNet++ classification at full width
    (``configs/pointnet2_modelnet40.yaml`` on the fixture: SSG, 1,024
    points, 40 classes, batch 24, augmentation; seed weights): ``fps``
    and ``gather_rows`` bit-equal to their plain versions on the path's
    calls at batch 24, on fixture clouds, masked tails (down to one valid
    point and none) and a ties-heavy cloud on a coarse grid; predict
    through ``infer`` at batch 24 and 1 (2 ``fps`` and 2 ``gather_rows``
    launches, nothing else), the kernel route against the plain route;
    train steps at batch 24 (1 ``scatter_rows`` a step, checked bit-equal
    too), the first step against the plain route; a short
    ``train(cfg)``. Returns (pipe, cfg, first train batch, launches of
    the batch-24 predict, launches of the train steps, the largest
    |difference| per kernel)."""
    import numpy as np
    import torch
    from lisec_tpu_torch.api import build_model, infer
    name = "pointnet2_modelnet40"
    cfg = cls_config(POINTNET2_CLS_CFG)
    if cfg.train.batch_size != 24 or cfg.budget.max_points != 1024 \
            or cfg.model.params.get("width", 1) != 1 \
            or cfg.data.augment.dropout_max != 0.875:
        raise AssertionError(f"{name}: not the full-width config")
    pipe = build_model(cfg)                        # weights from seed 0
    b = cfg.train.batch_size
    worst = {"fps": 0.0, "gather_rows": 0.0, "scatter_rows": 0.0}

    fixture = partseg_batch(pipe, cfg, b)
    masked = {k: v.copy() for k, v in fixture.items()}
    for i, valid in enumerate((700, 300, 1, 0)):    # SA1 picks 512
        masked["point_mask"][i, valid:] = False
    ties = {k: v.copy() for k, v in fixture.items()}
    ties["points"] = (np.round(ties["points"] * 4) / 4).astype(np.float32)
    for case, batch in (("fixture", fixture), ("masked_tails", masked),
                        ("ties", ties)):
        with checked_point_ops(worst, case), torch.no_grad():
            pipe.predict(pipe.device_batch(batch))

    predict_launches = {}
    for bb in (b, 1):
        batch = partseg_batch(pipe, cfg, bb)
        zero_all_launches()
        out = infer(pipe, batch)
        torch.cuda.synchronize()
        launches = predict_launches[bb] = all_launches()
        if launches != CLS_LAUNCHES_PER_PREDICT:
            raise AssertionError(f"{name} predict launches {launches}, "
                                 f"expected {CLS_LAUNCHES_PER_PREDICT}")
        check_cls_outputs(out, bb, cfg.data.num_classes, name)
        before = all_launches()
        with plain_point_ops():
            plain = infer(pipe, batch)
        if all_launches() != before:
            raise AssertionError("the plain route launched a kernel")
        diff = float((out["logits"] - plain["logits"]).abs().max())
        scale = float(plain["logits"].abs().max())
        if diff > 1e-5 * scale or not torch.equal(out["labels"],
                                                  plain["labels"]):
            raise AssertionError(f"{name} kernel vs plain route: logits "
                                 f"differ by {diff} (largest {scale})")
        emit("cls_main_path", config=name, batch=bb, launches=launches,
             logits_max_abs=scale, max_abs_diff_vs_plain=diff,
             logits_bit_equal_to_plain=bool(torch.equal(out["logits"],
                                                        plain["logits"])),
             labels_equal_to_plain=True,
             accuracy_seed_weights=float(
                 (out["labels"].cpu().numpy() == batch["label"]).mean()))

    first, start, train_launches = cls_train_steps(
        name, pipe, cfg, CLS_LAUNCHES_PER_TRAIN_STEP)
    # Kernels against plain versions, dropout the identity: FPS and the
    # gathers are exact on both routes and the scatter adds in the same
    # order, so the loss within 1e-5 relative and every gradient within
    # 1e-3 of its L2 norm (bit-equal expected). The kernel run's calls
    # are checked bit-equal on the way.
    pipe.model.head.dropout_rate = 0.0
    pipe.model.load_state_dict(start)
    with checked_point_ops(worst, "train_step"):
        loss_k, acc_k, grads_k = cls_loss_and_grads(pipe, first)
    pipe.model.load_state_dict(start)
    before = all_launches()
    with plain_point_ops():
        loss_p, acc_p, grads_p = cls_loss_and_grads(pipe, first)
    if all_launches() != before:
        raise AssertionError("the plain run launched a kernel")
    pipe.model.head.dropout_rate = 0.4
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst_g, worst_name = worst_grad(grads_k, grads_p)
    emit("train_vs_plain", config=name, dropout="identity",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         loss=float(loss_k), plain_loss=float(loss_p), loss_rel_diff=rel_loss,
         worst_grad_rel_l2=worst_g, worst_grad=worst_name,
         gradients=len(grads_k),
         gradients_bit_equal=all(torch.equal(grads_k[k], grads_p[k])
                                 for k in grads_k))
    if rel_loss > 1e-5 or float(acc_k) != float(acc_p) or worst_g > 1e-3:
        raise AssertionError(f"{name} kernel vs plain: loss {rel_loss}, "
                             f"gradient of {worst_name} {worst_g}")
    cls_short_train(name, POINTNET2_CLS_CFG)
    pipe.model.load_state_dict(start)
    return pipe, cfg, first, predict_launches[b], train_launches, worst


def first_batch_against_record(out):
    """The snapshot's first held-out batch against the JAX package's
    predict of it (``docs/convergence/pphard_trained_outputs.npz``): per
    frame the kept counts, and each recorded box's best BEV IoU with a
    kept box and that box's score less the recorded one."""
    import numpy as np
    from lisec_tpu_torch.eval.detection import iou_matrix_np
    ref = np.load(os.path.join(ROOT, "docs", "convergence",
                               "pphard_trained_outputs.npz"))
    frames = []
    for i in range(len(ref["valid"])):
        rv, pv = ref["valid"][i], out["valid"][i]
        iou = iou_matrix_np(ref["boxes"][i][rv].astype(np.float64),
                            out["boxes"][i][pv].astype(np.float64), "bev")
        j = iou.argmax(1) if iou.size else np.zeros(int(rv.sum()), int)
        frames.append({
            "kept": int(pv.sum()), "recorded": int(rv.sum()),
            "best_iou": iou.max(1).round(4).tolist() if iou.size else [],
            "score_minus_recorded": (out["scores"][i][pv][j]
                                     - ref["scores"][i][rv]).round(4)
            .tolist() if iou.size else []})
    return frames


# The JAX package's ``evaluate`` of the trained snapshot over the same 256
# held-out frames, on the CPU (``JAX_PLATFORMS=cpu python -m
# tests.test_torch_eval``): with its production encoder kernel, whose
# bf16 canvas routes each cell's max of u + BIG as one bf16 value, and
# with its reference encoder path (``model.params.fast_encoder=false``),
# an exact cell max as the port's encoder computes it.
JAX_CPU_SNAPSHOT_EVAL = {
    "production_encoder": {
        "recall@0.5": 0.7412109375, "mean_detections": 10.08203125,
        "class0_3d_ap_easy_official": 93.23753188383242,
        "class0_3d_ap_moderate_official": 94.39488212969523,
        "class0_3d_ap_hard_official": 91.05650559899424},
    "reference_encoder": {
        "recall@0.5": 0.74267578125, "mean_detections": 10.04296875,
        "class0_3d_ap_easy_official": 95.28549719366366,
        "class0_3d_ap_moderate_official": 94.752786361657,
        "class0_3d_ap_hard_official": 91.42764319126812},
}
SNAPSHOT_APS = tuple(f"class0_3d_ap_{b}_official"
                     for b in ("easy", "moderate", "hard"))


def snapshot_gaps(got, want):
    """recall@0.5 and each official 3D AP less ``want``'s, and the
    detections a frame over ``want``'s less 1."""
    return {"recall@0.5": got["recall@0.5"] - want["recall@0.5"],
            "mean_detections_rel": got["mean_detections"]
            / want["mean_detections"] - 1,
            **{k: got[k] - want[k] for k in SNAPSHOT_APS}}


def phase_evaluate(partseg_pipe, rangeseg_pipe, pn_pipe, pn2_pipe):
    """``evaluate`` on the card. The trained PointPillars snapshot in
    ``configs/pointpillars_fixture_hard_conv.yaml`` (batch 4) through
    ``lisec_tpu_torch.evaluate`` over the whole 256-frame held-out split,
    held to the JAX package's evaluation with the exact encoder
    (``JAX_CPU_SNAPSHOT_EVAL``): recall@0.5 within 0.02, each official
    3D AP within 2.0 points, detections a frame within 5%. Read beside
    it: the JAX package's record of the snapshot on the TPU
    (``docs/convergence/pphard_eval.json``) and its production encoder's
    evaluation on the CPU, both made by the encoder kernel's bf16
    routing; the first batch beside the JAX predict of it on the TPU.
    Then ``evaluate(max_batches=2)`` of both classifiers, part and range
    segmentation and SECOND (seed weights, full width), the kernel route
    against the plain route: the same metrics. Prints the wall
    seconds."""
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.config import apply_overrides, load_config
    from lisec_tpu_torch.weights import load_weights_npz
    t_phase = time.perf_counter()
    cfg = apply_overrides(load_config(TRAIN_CFG), ['train.ckpt_dir=""'])
    pipe = build_model(cfg)
    load_weights_npz(pipe.model, WEIGHTS)
    with open(os.path.join(ROOT, "docs", "convergence",
                           "pphard_eval.json")) as f:
        tpu_record = json.load(f)
    first = next(pipe.eval_outputs("val", 1))[1]
    zero_all_launches()
    t0 = time.perf_counter()
    got = lisec_tpu_torch.evaluate(cfg, pipe)
    seconds = time.perf_counter() - t0
    launches = all_launches()
    frames = len(pipe.make_dataset("val"))
    gaps = snapshot_gaps(got, JAX_CPU_SNAPSHOT_EVAL["reference_encoder"])
    emit("evaluate", config="pointpillars_fixture_hard_conv",
         weights="pointpillars_fixture_hard.npz", split="val", frames=frames,
         batch=cfg.train.batch_size, metrics=got,
         jax_cpu_reference_encoder=JAX_CPU_SNAPSHOT_EVAL["reference_encoder"],
         gaps=gaps,
         gaps_to_jax_cpu_production_encoder=snapshot_gaps(
             got, JAX_CPU_SNAPSHOT_EVAL["production_encoder"]),
         jax_tpu_record=tpu_record,
         gaps_to_jax_tpu_record=snapshot_gaps(got, tpu_record),
         launches=launches, seconds=seconds,
         first_batch=first_batch_against_record(first))
    if frames != 256 or launches["pillar_canvas_fused"] != frames // 4 \
            or abs(gaps["recall@0.5"]) > 0.02 \
            or abs(gaps["mean_detections_rel"]) > 0.05 \
            or any(abs(gaps[k]) > 2.0 for k in SNAPSHOT_APS):
        raise AssertionError(f"snapshot evaluation off the JAX package's "
                             f"with the exact encoder: {gaps}")

    second = build_model(train_config(SECOND_TRAIN_CFG, 1))
    torch.backends.cudnn.deterministic = True
    for name, p, plain_ops in (
            ("pointnet_cls_fixture_conv", pn_pipe, None),
            ("pointnet2_modelnet40", pn2_pipe, plain_point_ops),
            ("pointnet2_partseg_fixture_conv", partseg_pipe,
             plain_point_ops),
            ("rangeseg_fixture_conv", rangeseg_pipe, plain_segment_ops),
            ("second_fixture_conv", second, plain_segment_ops)):
        zero_all_launches()
        t0 = time.perf_counter()
        kernel = p.evaluate(max_batches=2)
        seconds = time.perf_counter() - t0
        launches = all_launches()
        plain = kernel
        if plain_ops is not None:
            with plain_ops():
                plain = p.evaluate(max_batches=2)
            if all_launches() != launches:
                raise AssertionError("the plain route launched a kernel")
        elif launches != NO_LAUNCHES:
            raise AssertionError(f"{name} evaluate launched {launches}")
        if kernel.keys() != plain.keys() or any(
                abs(kernel[k] - plain[k]) > 1e-6 for k in kernel):
            raise AssertionError(f"{name} evaluate: kernel route {kernel}, "
                                 f"plain route {plain}")
        emit("evaluate", config=name, weights="seed", max_batches=2,
             batch=p.cfg.train.batch_size, metrics=kernel,
             plain_route_equal=True, launches=launches, seconds=seconds)
    torch.backends.cudnn.deterministic = False
    emit("evaluate_wall", seconds=time.perf_counter() - t_phase)


def cls_train_parts(pipe, batch):
    """Mean ms of a train step's forward, loss, backward and optimizer
    update, by CUDA events (2 warm-ups, 5 runs)."""
    import torch
    from lisec_tpu_torch.models.pointnet import orthogonality_loss
    from lisec_tpu_torch.training.losses import cross_entropy
    dev = pipe.device_batch(batch)
    parts = dict.fromkeys(("forward", "loss", "backward", "optimizer"), 0.0)
    with torch.enable_grad():
        for it in range(7):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            pipe.model.train()
            pipe.optimizer.zero_grad()
            ev[0].record()
            out = pipe.model(dev["points"], dev["point_mask"],
                             rng=pipe.step_key())
            ev[1].record()
            loss = cross_entropy(out["logits"], dev["label"])
            if out["feature_transform"] is not None:
                loss = loss + pipe.reg_weight * orthogonality_loss(
                    out["feature_transform"])
            ev[2].record()
            loss.backward()
            ev[3].record()
            pipe.optimizer.step()
            ev[4].record()
            torch.cuda.synchronize()
            if it >= 2:
                for i, k in enumerate(parts):
                    parts[k] += ev[i].elapsed_time(ev[i + 1]) / 5
    return parts


def phase_cls_timing(runs):
    """Each classifier's predict at its training batch and at 1 (from host
    numpy and device-resident) and its train step with its parts; then
    every ``fps``, ``gather_rows`` and ``scatter_rows`` call of a
    batch-24 PointNet2Cls predict and of its train step's backward, on the
    tensors the path hands them. ``runs``: (name, pipe, cfg, first train
    batch) of each. Returns (fps rows, gather rows, scatter rows)."""
    import torch
    from lisec_tpu_torch.api import infer
    for name, pipe, cfg, first in runs:
        for b in (cfg.train.batch_size, 1):
            batch = partseg_batch(pipe, cfg, b)
            ms = cuda_ms(lambda: infer(pipe, batch), iters=10)
            dev = pipe.device_batch(batch)
            with torch.no_grad():
                ms_dev = cuda_ms(lambda: pipe.predict(dev), iters=10)
            emit("cls_predict", config=name, batch=b, ms_per_batch=ms,
                 clouds_per_s=b * 1e3 / ms, device_resident_ms=ms_dev,
                 device_resident_clouds_per_s=b * 1e3 / ms_dev)
        b = cfg.train.batch_size
        with torch.enable_grad():
            ms_step = cuda_ms(lambda: pipe.train_step(first), iters=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                pipe.train_step(first)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / 5 * 1e3
        emit("cls_train_step", config=name, batch=b, ms_per_step=ms_step,
             clouds_per_s=b * 1e3 / ms_step, host_clock_ms_per_step=host_ms,
             host_clock_clouds_per_s=b * 1e3 / host_ms,
             **{f"{k}_ms": v for k, v in cls_train_parts(pipe,
                                                         first).items()})

    # What one batch-24 PointNet2Cls predict and one train step hand the
    # kernels.
    _, pipe, cfg, first = runs[1]
    dev = pipe.device_batch(partseg_batch(pipe, cfg, cfg.train.batch_size))
    pipe.model.eval()                  # the train steps above left train()
    rows = point_kernel_rows(lambda: pipe.predict(dev),
                             lambda: cls_loss_and_grads(pipe, first))
    for kernel, per_call in zip(("fps", "gather_rows", "scatter_rows"), rows):
        for i, call in enumerate(per_call):
            emit("cls_kernel", config="pointnet2_modelnet40", kernel=kernel,
                 call=i, **call)
    if [len(r) for r in rows] != [2, 2, 1] or sum(
            "centers" in r for r in rows[1]) != 2:
        raise AssertionError(f"cls kernel calls {[len(r) for r in rows]}")
    return rows


# -- phase 11: the shipped detector configs as written ------------------------

AS_WRITTEN_STEPS = 4        # saves at 1 (the first), 2 (ckpt_every), 4 (last)
RESUME_STEPS = 6            # the killed run dies after step 3, its save
RATE_STEPS = 100            # the clouds/s runs, logged at 1, 20, ..., 100;
RATE_LOG_EVERY = 20         # the rate is read from the log at 20 to 100
RATE_ORDER = ("true", "false", "false", "true")   # augmentation, per run


class Preempted(Exception):
    """Stands for a run killed between two steps."""


def as_written(path, ckpt_dir, num_steps, ckpt_every, *extra):
    """A shipped training config with only its checkpoint directory, step
    count and save interval overridden (``extra``: the timing runs'
    further overrides)."""
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(path), [
        f"train.ckpt_dir={ckpt_dir}", f"train.num_steps={num_steps}",
        f"train.ckpt_every={ckpt_every}", *extra])


def train_quiet(cfg):
    import torch
    import lisec_tpu_torch
    with torch.enable_grad():
        pipe, history = lisec_tpu_torch.train(cfg, progress=False)
    torch.cuda.synchronize()
    return pipe, history


def state_gap(a, b):
    """(largest absolute difference, names that differ) over two
    ``Pipeline.state_dict()``s: every parameter, running statistic,
    optimizer moment and step count."""
    import torch
    flat = {}
    for side, st in enumerate((a, b)):
        for k, v in st["model"].items():
            flat.setdefault(f"model/{k}", [None, None])[side] = v
        opt = st["optimizer"]["optimizer"]["state"]
        for i, slots in opt.items():
            for k, v in slots.items():
                flat.setdefault(f"optimizer/{i}/{k}", [None, None])[side] = v
    if a["optimizer"]["count"] != b["optimizer"]["count"]:
        raise AssertionError("optimizer counts "
                             f"{a['optimizer']['count']} and "
                             f"{b['optimizer']['count']}")
    worst, differ = 0.0, []
    for k, (x, y) in flat.items():
        if x is None or y is None:
            raise AssertionError(f"{k} is in one state only")
        if not torch.equal(x, y):
            differ.append(k)
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst, differ


def steady_clouds_per_s(history, batch):
    """The loop's own rate between its second log and its last: each
    record's ``clouds_per_sec`` is the clouds since the loop started over
    the seconds since then, so the steps between take (clouds at the last
    log - clouds at the second) over the seconds between the two. The
    first ``RATE_LOG_EVERY`` steps are left out: the prefetch queue fills
    during them, so its batches made ahead do not flatter the window."""
    logs = [r for r in history if "clouds_per_sec" in r]
    first, last = logs[1], logs[-1]
    if first["step"] != RATE_LOG_EVERY or last["step"] != RATE_STEPS:
        raise AssertionError(f"rate window {first['step']}-{last['step']}")
    seconds = (last["step"] * batch / last["clouds_per_sec"]
               - first["step"] * batch / first["clouds_per_sec"])
    return (last["step"] - first["step"]) * batch / seconds


def phase_configs_as_written(tmp):
    """``lisec_tpu_torch.train(cfg)`` on ``configs/pointpillars_fixture_
    hard_conv.yaml`` and ``configs/second_fixture_conv.yaml`` as shipped,
    their augmentation on (GT sampling, per-box noise, flip, rotation,
    scale), checkpoints in a temporary directory: the launch counts (set
    to 0 just before each run, read just after), the steps kept on disk
    and ``metrics.jsonl``. Then resume on the card: two unbroken runs of
    the PointPillars config, and one killed after its step-3 save and
    resumed, held bit-equal (or, should the two unbroken runs differ, to
    their gap, with the ops named). Then the command line's ``infer`` from
    a checkpoint against the pipeline's ``infer``, and the card's
    numbers: clouds/s with the augmentation on and off (and the host's
    batches alone), the GT database's build, one save and one
    restore."""
    import warnings
    import numpy as np
    import torch
    import lisec_tpu_torch
    from lisec_tpu_torch import cli
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.data.fixtures import make_detection_scene_hard
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.pipelines.base import Pipeline
    from lisec_tpu_torch.training.checkpoint import CheckpointManager
    from lisec_tpu_torch.weights import load_weights_npz
    detectors = (
        ("pointpillars_fixture_hard_conv", TRAIN_CFG,
         POINTPILLARS_LAUNCHES_PER_TRAIN_STEP),
        ("second_fixture_conv", SECOND_TRAIN_CFG,
         SECOND_LAUNCHES_PER_TRAIN_STEP))
    result = {"launches_per_train_step": {}}

    # The GT database over the 256 train scenes: first with the scenes
    # generated on the host, then from the scene cache.
    for name, path, _ in detectors:
        pipe = build_model(as_written(path, "", 1, 1))
        builds = []
        for _ in range(2):
            t0 = time.perf_counter()
            sampler_fn = pipe.augment_fn("train")
            builds.append(time.perf_counter() - t0)
        if sampler_fn is None:
            raise AssertionError(f"{name}: augmentation is off as shipped")
        emit("gt_database", config=name, scenes=pipe.cfg.data.fixture_size,
             first_build_s=builds[0], cached_build_s=builds[1])
        del pipe

    for name, path, per_step in detectors:
        d = os.path.join(tmp, name)
        cfg = as_written(path, d, AS_WRITTEN_STEPS, 2)
        aug = cfg.data.augment
        if not (aug.enabled and aug.gt_sampling and aug.box_noise_rot > 0
                and aug.box_noise_trans > 0 and aug.global_flip_y
                and aug.global_rotate > 0):
            raise AssertionError(f"{name}: the shipped recipe is not on")
        zero_segment_launches()
        t0 = time.perf_counter()
        pipe, history = train_quiet(cfg)
        seconds = time.perf_counter() - t0
        launches = segment_launches()
        if launches != {k: v * AS_WRITTEN_STEPS for k, v in per_step.items()}:
            raise AssertionError(
                f"{name} as written: launches {launches} in "
                f"{AS_WRITTEN_STEPS} steps, expected {per_step} a step")
        kept = CheckpointManager(d).all_steps()
        if kept != [1, 2, AS_WRITTEN_STEPS] or pipe.step != AS_WRITTEN_STEPS:
            raise AssertionError(f"{name}: checkpoints {kept}, step "
                                 f"{pipe.step}")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if records != history or [r["step"] for r in records] != [1]:
            raise AssertionError(f"{name}: metrics.jsonl {records}")
        for rec in records:
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f"{name}: non-finite {rec}")
        result["launches_per_train_step"][name] = {
            k: v / AS_WRITTEN_STEPS for k, v in launches.items()}
        emit("config_as_written", config=name, steps=AS_WRITTEN_STEPS,
             launches=launches, checkpoints=kept, metrics=records,
             seconds_with_gt_database=seconds)
        del pipe

    # Resume on the card, cuDNN held to deterministic algorithms.
    torch.backends.cudnn.deterministic = True
    runs = {}
    for run in ("a", "b"):
        runs[run] = train_quiet(as_written(
            TRAIN_CFG, os.path.join(tmp, f"resume_{run}"), RESUME_STEPS,
            RESUME_STEPS // 2))[0]
    two_runs, two_runs_differ = state_gap(runs["a"].state_dict(),
                                          runs["b"].state_dict())
    killed_dir = os.path.join(tmp, "resume_killed")
    train_step = Pipeline.train_step

    def dies_after_the_save(self, batch, rng=None):
        if self.step == RESUME_STEPS // 2:
            raise Preempted
        return train_step(self, batch, rng)
    Pipeline.train_step = dies_after_the_save
    try:
        train_quiet(as_written(TRAIN_CFG, killed_dir, RESUME_STEPS,
                               RESUME_STEPS // 2))
        raise AssertionError("the killed run was not killed")
    except Preempted:
        pass
    finally:
        Pipeline.train_step = train_step
    if CheckpointManager(killed_dir).latest_step() != RESUME_STEPS // 2:
        raise AssertionError("the killed run left no step-3 checkpoint")
    resumed, resumed_history = train_quiet(as_written(
        TRAIN_CFG, killed_dir, RESUME_STEPS, RESUME_STEPS // 2,
        "train.resume=auto"))
    if resumed.step != RESUME_STEPS or \
            resumed_history[0]["step"] != RESUME_STEPS // 2 + 1:
        raise AssertionError(f"resumed at step {resumed_history[0]['step']},"
                             f" ended at {resumed.step}")
    gap, differ = state_gap(runs["a"].state_dict(), resumed.state_dict())
    named_ops = []
    if two_runs_differ:
        # Name the ops that have no deterministic CUDA implementation.
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_quiet(as_written(TRAIN_CFG, "", 2, 1))
        torch.use_deterministic_algorithms(False)
        named_ops = sorted({str(w.message).split("\n")[0] for w in caught})
    torch.backends.cudnn.deterministic = False
    emit("resume_on_card", config="pointpillars_fixture_hard_conv",
         steps=RESUME_STEPS, killed_after=RESUME_STEPS // 2,
         resumed_gap=gap, resumed_tensors_differ=len(differ),
         two_unbroken_runs_gap=two_runs,
         two_unbroken_runs_tensors_differ=len(two_runs_differ),
         differ=differ[:10], two_runs_differ=two_runs_differ[:10],
         nondeterministic_ops=named_ops)
    if (gap > two_runs) or (not two_runs_differ and differ):
        raise AssertionError(f"resume: {len(differ)} tensors differ by up to "
                             f"{gap}; two unbroken runs {two_runs}")
    result["resume_gap"], result["two_runs_gap"] = gap, two_runs

    # Serving from a checkpoint, through the command line: the trained
    # snapshot's weights in the resumed run's training state, so that
    # the served boxes are real detections.
    trained = runs["a"]
    load_weights_npz(trained.model, WEIGHTS)
    serve_dir = os.path.join(tmp, "serve")
    CheckpointManager(serve_dir).save(RESUME_STEPS, trained, force=True)
    cloud_path = os.path.join(tmp, "cloud.npy")
    np.save(cloud_path, make_detection_scene_hard(30_000)["points"])
    torch.backends.cudnn.deterministic = True
    ek.LAUNCHES = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        served = cli.main(["infer", TRAIN_CFG, "--cloud", cloud_path,
                           "--ckpt", serve_dir])
    torch.cuda.synchronize()
    cli_launches = ek.LAUNCHES
    cloud = lisec_tpu_torch.load_cloud(cloud_path)
    batch = {k: v[None] for k, v in
             lisec_tpu_torch.preprocess(cloud, trained.cfg).items()}
    want = lisec_tpu_torch.infer(trained, batch)
    torch.backends.cudnn.deterministic = False
    if cli_launches != 1:
        raise AssertionError(f"cli infer: {cli_launches} encoder launches")
    if not want["valid"].any():
        raise AssertionError("the snapshot detected nothing in the scene")
    if served.keys() != want.keys() or not all(
            torch.equal(served[k], want[k]) for k in want):
        raise AssertionError("cli infer from the checkpoint differs from "
                             "the trained pipeline's infer")
    shown = json.loads(printed.getvalue())
    if shown != {k: v[0].cpu().tolist() for k, v in want.items()
                 if k != "logits"}:
        raise AssertionError("cli infer printed other outputs")
    result["cli_launches"] = cli_launches
    emit("serve_from_checkpoint", config="pointpillars_fixture_hard_conv",
         step=RESUME_STEPS, points=len(cloud), launches=cli_launches,
         kept_boxes=int(want["valid"].sum()), outputs=sorted(want))

    # One save and one restore of the trained PointPillars state.
    mgr = CheckpointManager(os.path.join(tmp, "timing"), keep=1)
    save_ms, restore_ms = [], []
    for step in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(step, trained, force=True)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        mgr.restore(resumed)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    if state_gap(trained.state_dict(), resumed.state_dict())[1]:
        raise AssertionError("restore: the state differs from the saved one")
    emit("checkpoint_io", config="pointpillars_fixture_hard_conv",
         save_ms=save_ms, restore_ms=restore_ms,
         file_mb=os.path.getsize(os.path.join(mgr.directory, "3.pt")) / 1e6)
    del runs, trained, resumed

    # clouds/s of train(cfg), augmentation on and off, no checkpoints,
    # in the order on, off, off, on (two readings each); beside it the
    # host's batches alone (made in this thread, with no training beside
    # them), ms a batch.
    for name, path, _ in detectors:
        rates, host_ms = {"true": [], "false": []}, {}
        for aug in RATE_ORDER:
            cfg = as_written(path, "", RATE_STEPS, RATE_STEPS,
                             f"train.log_every={RATE_LOG_EVERY}",
                             f"data.augment.enabled={aug}")
            pipe, history = train_quiet(cfg)
            rates[aug].append(
                steady_clouds_per_s(history, cfg.train.batch_size))
            if aug not in host_ms:
                batches = make_batches(
                    pipe.make_dataset("train"), cfg.budget,
                    cfg.train.batch_size, shuffle=True,
                    seed=cfg.train.seed, augment_fn=pipe.augment_fn("train"))
                next(batches)
                t0 = time.perf_counter()
                for _ in range(RATE_STEPS):
                    next(batches)
                host_ms[aug] = ((time.perf_counter() - t0) / RATE_STEPS
                                * 1e3)
            del pipe
        on, off = rates["true"], rates["false"]
        emit("train_clouds_per_s", config=name, batch=cfg.train.batch_size,
             steps=RATE_STEPS - RATE_LOG_EVERY, augment_on=on,
             augment_off=off,
             on_over_off=[a / b for a, b in zip(on, off)],
             host_batch_ms_augment_on=host_ms["true"],
             host_batch_ms_augment_off=host_ms["false"])
    return result


# -- phase 12: the voxel-buffer path and the int16 wire ----------------------

VOXEL_BUFFER = ("model.params.fused=false",)
THREE_CLASS_CFG = os.path.join(ROOT, "configs",
                               "pointpillars_kitti_3class.yaml")
VOXEL_BUFFER_LAUNCHES_PER_PREDICT = {
    "pillar_canvas_fused": 0, "segment_paint": 1, "segment_unpaint": 0,
    "spread_accumulate": 0, "fps": 0, "gather_rows": 0, "scatter_rows": 0,
    "threefry": 0, **NO_SPCONV}
# The voxelizer's paint and the assigner's; no unpaint (autograd's gather
# is the scatter's backward).
VOXEL_BUFFER_LAUNCHES_PER_TRAIN_STEP = {
    "segment_paint": 2, "segment_unpaint": 0, "spread_accumulate": 0,
    **NO_SPCONV}
ENCODER_ONLY = {**VOXEL_BUFFER_LAUNCHES_PER_PREDICT,
                "pillar_canvas_fused": 1, "segment_paint": 0}


def voxel_table_call(pipe, batch):
    """The one ``segment_paint`` call the voxelizer makes on a batch (its
    (B, N, 8) rows into the (B, P * K, 8) slot table), recorded as
    (vals, ids, num_cells, num_max, split), and the voxelizer's output."""
    import torch
    calls = {}
    dev = pipe.device_batch(batch)
    with recorded_segment_calls(calls):
        vox = pipe._voxelize_batch(dev["points"], dev["point_mask"])
    torch.cuda.synchronize()
    (call,) = calls["segment_paint"]
    return call, vox


def phase_voxel_table_kernel_check(pipe, cfg):
    """``segment_paint`` bit-equal to its plain version on the voxel
    table's calls: ray-cast scenes at batch 8 and 32, and four edge
    clouds (a ray-cast scene; one with 500 points in one pillar, more
    than K = 32; 32,768 points spread over the whole range, more than
    P = 12,000 non-empty pillars; one with every point masked). Every
    slot holds at most one row, so the sums are placements and the
    tables equal bit for bit. Returns the batch-8 and batch-32 calls."""
    import torch
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    batches = {f"ray_cast_b{b}": scene_batch(cfg, b)[0] for b in (8, 32)}
    edge, _ = scene_batch(cfg, 4, seed0=200)
    rng = torch.Generator().manual_seed(12)
    r = cfg.voxel.point_cloud_range
    crowd = torch.rand((500, 4), generator=rng) * torch.tensor(
        [0.15, 0.15, 2.0, 1.0]) + torch.tensor([10.0, 0.0, -2.0, 0.0])
    edge["points"][1, :500] = crowd.numpy()
    edge["point_mask"][1, :500] = True
    n = edge["points"].shape[1]
    spread = torch.rand((n, 4), generator=rng) * torch.tensor(
        [r[3] - r[0], r[4] - r[1], r[5] - r[2], 1.0]) + torch.tensor(
        [r[0], r[1], r[2], 0.0])
    edge["points"][2] = spread.numpy()
    edge["point_mask"][2] = True
    edge["point_mask"][3] = False
    batches["edges"] = edge
    kk = cfg.budget.max_points_per_voxel
    calls = {}
    for case, batch in batches.items():
        (vals, ids, nc, num_max, split), vox = voxel_table_call(pipe, batch)
        got = sp.segment_paint(vals, ids, num_cells=nc, num_max=num_max)
        torch.cuda.synchronize()
        ref = sp.segment_paint_reference(vals, ids, num_cells=nc,
                                         num_max=num_max)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"segment_paint voxel table {case}: "
                f"{int((got != ref).sum())} elements differ")
        if case == "edges":
            nv, npts = vox.num_voxels.tolist(), vox.num_points
            if (int(npts[1].max()) != kk or nv[2] != cfg.budget.max_voxels
                    or nv[3] != 0 or int(npts[3].sum()) != 0
                    or bool(got[3].any())):
                raise AssertionError(f"voxel table edges: num_voxels {nv}, "
                                     f"largest pillar {int(npts[1].max())}")
        emit("kernel_check", kernel="segment_paint", case=f"voxel_{case}",
             shape=list(got.shape), num_max=num_max, table="bit-equal",
             rows_placed=int(((ids >= 0) & (ids < nc)).sum()),
             num_voxels=vox.num_voxels.tolist(),
             largest_pillar=int(vox.num_points.max()))
        calls[case] = (vals, ids, nc, num_max, split)
    return calls


def predict_ms(pipe, dev, iters=10):
    """Device-resident predict and model forward (ms, CUDA events)."""
    import torch
    with torch.no_grad():
        return (cuda_ms(lambda: pipe.predict(dev), iters),
                cuda_ms(lambda: pipe.model(*pipe._model_args(dev)), iters))


def voxel_buffer_snapshot(path):
    """The trained snapshot as the voxel-buffer model's ``state_dict``: the
    fused encoder's kernel and BatchNorm are the feature net's Dense and
    BatchNorm (the same nine features in the same order; the fused
    encoder folds that BatchNorm only at inference), so they are renamed;
    the backbone and head stay as they are."""
    import numpy as np
    from lisec_tpu_torch.weights import convert_flax_arrays
    with np.load(path) as data:
        flat = {}
        for key in data.files:
            col, module, leaf = (key.split("/") + [""])[:3]
            if module == "FusedPillarEncoder_0":
                layer = "Dense_0" if leaf == "kernel" else "BatchNorm_0"
                flat[f"{col}/PillarFeatureNet_0/{layer}/{leaf}"] = data[key]
            else:
                flat[key] = data[key]
    return convert_flax_arrays(flat, "pointpillars")


def voxel_buffer_predict(pipe, cfg, fused_pipe, b, weights):
    """One voxel-buffer predict at batch ``b`` through ``infer``, its
    launches (the counts set to 0 just before, read just after), the
    kernel route against the plain route, and the device-resident predict
    and forward timed beside the fused model's with the same weights."""
    import torch
    from lisec_tpu_torch.api import infer
    batch, gts = scene_batch(cfg, b)
    zero_all_launches()
    out = infer(pipe, batch)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != VOXEL_BUFFER_LAUNCHES_PER_PREDICT:
        raise AssertionError(f"voxel-buffer predict at batch {b} "
                             f"launched {launches}")
    for k in ("boxes", "scores"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"voxel-buffer predict: non-finite {k}")
    if out["boxes"].shape != (b, cfg.budget.nms_post, 7):
        raise AssertionError(f"voxel-buffer boxes "
                             f"{tuple(out['boxes'].shape)}")
    with plain_segment_ops():
        plain = infer(pipe, batch)
    torch.cuda.synchronize()
    if all_launches() != launches:
        raise AssertionError("the plain voxel-buffer run launched a kernel")
    same_outputs(out, plain, f"voxel-buffer kernel vs plain route b{b}",
                 1e-3)
    fused = infer(fused_pipe, batch)
    dev = pipe.device_batch(batch)
    # In turns: fused, voxel buffer, voxel buffer, fused.
    f1 = predict_ms(fused_pipe, dev)
    v1 = predict_ms(pipe, dev)
    v2 = predict_ms(pipe, dev)
    f2 = predict_ms(fused_pipe, dev)
    row = dict(config="pointpillars_kitti", overrides=list(VOXEL_BUFFER),
               weights=weights, batch=b, launches=launches,
               kept_per_cloud=out["valid"].sum(1).tolist(),
               recall_at_iou_half=recall_at_half(out, gts),
               fused_kept_per_cloud=fused["valid"].sum(1).tolist(),
               fused_recall_at_iou_half=recall_at_half(fused, gts),
               plain_route="keep sets and labels equal, boxes within 1e-3",
               ms_per_batch=cuda_ms(lambda: infer(pipe, batch), 10),
               device_resident_ms=[v1[0], v2[0]],
               model_forward_ms=[v1[1], v2[1]],
               fused_device_resident_ms=[f1[0], f2[0]],
               fused_model_forward_ms=[f1[1], f2[1]])
    return row, dev


def phase_voxel_buffer_path(pipe, cfg, seed_fused, trained_fused,
                            table_calls):
    """``configs/pointpillars_kitti.yaml`` with ``fused: false`` at full
    width (bf16) through ``build_model`` and ``infer`` at batch 8 and 32:
    1 ``segment_paint`` and no encoder launch a predict, the kernel route
    against the plain route (boxes within 1e-3, keep sets and labels
    equal), timed beside the fused model with the same weights: the seed
    weights, then the trained snapshot (``voxel_buffer_snapshot``), where
    the two models keep boxes and their recall can be read side by side.
    Returns the launches a predict and the voxel-table calls' timing
    rows."""
    out_rows = {}
    for b in (8, 32):
        row, dev = voxel_buffer_predict(pipe, cfg, seed_fused, b, "seed 0")
        vox = pipe._voxelize_batch(dev["points"], dev["point_mask"])
        out_rows[b] = paint_call_row(*table_calls[f"ray_cast_b{b}"])
        emit("voxel_buffer_predict", **row,
             voxelize_ms=cuda_ms(lambda: pipe._voxelize_batch(
                 dev["points"], dev["point_mask"]), 10),
             num_voxels=vox.num_voxels.tolist(),
             voxel_table_paint=out_rows[b])
    seed_state = {k: v.clone() for k, v in pipe.model.state_dict().items()}
    pipe.model.load_state_dict(voxel_buffer_snapshot(WEIGHTS), strict=True)
    for b in (8, 32):
        row, _ = voxel_buffer_predict(pipe, cfg, trained_fused, b,
                                      os.path.relpath(WEIGHTS, ROOT))
        if not any(row["kept_per_cloud"]):
            raise AssertionError("voxel-buffer predict with the snapshot "
                                 "kept no box")
        emit("voxel_buffer_predict", **row)
    pipe.model.load_state_dict(seed_state)
    return row["launches"], out_rows


def phase_three_class():
    """The shipped 3-class config at full width (seed weights): predict
    at batch 8 on the card, one ``pillar_canvas_fused`` launch."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    cfg = load_config(THREE_CLASS_CFG)
    pipe = build_model(cfg)
    batch, _ = scene_batch(cfg, 8)
    zero_all_launches()
    out = infer(pipe, batch)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != ENCODER_ONLY:
        raise AssertionError(f"3-class predict launched {launches}")
    ny, nx = pipe.fmap
    labels = out["labels"][out["valid"]]
    if (pipe.anchors.shape != (ny * nx * 6, 7)
            or not torch.isfinite(out["boxes"]).all()
            or out["boxes"].shape != (8, cfg.budget.nms_post, 7)
            or not bool(((labels >= 0) & (labels < 3)).all())):
        raise AssertionError("3-class predict: anchors, boxes or labels")
    # Seed weights keep nothing at the config's threshold; at 0 every
    # candidate goes through NMS, and the kept boxes hold two of the
    # classes (the seed's draw scores the third under them everywhere).
    # Then each class in turn is the only one that can win an anchor
    # (the others' biases at -1e4): its boxes are kept, with its label.
    pipe.score_thr = 0.0
    all_kept = infer(pipe, batch)
    kept_labels = all_kept["labels"][all_kept["valid"]]
    per_class = torch.bincount(kept_labels.long(), minlength=3).tolist()
    if len(per_class) != 3 or sum(n > 0 for n in per_class) < 2:
        raise AssertionError(f"3-class predict at threshold 0: labels "
                             f"{per_class}")
    bias = pipe.model.head.cls.bias
    prior = bias.detach().clone()
    alone = []
    for k in range(3):
        with torch.no_grad():
            bias.copy_(prior)
            bias.view(-1, 3)[:, [c for c in range(3) if c != k]] = -1e4
        kept = infer(pipe, batch)
        labels_k = kept["labels"][kept["valid"]]
        if labels_k.numel() == 0 or not bool((labels_k == k).all()):
            raise AssertionError(f"3-class predict, class {k} alone: "
                                 f"labels {labels_k.tolist()[:10]}")
        alone.append(int(labels_k.numel()))
    with torch.no_grad():
        bias.copy_(prior)
    emit("three_class_predict", config="pointpillars_kitti_3class", batch=8,
         launches=launches, anchors=list(pipe.anchors.shape),
         kept_per_cloud=out["valid"].sum(1).tolist(),
         labels_kept=torch.bincount(labels.long(), minlength=3).tolist(),
         kept_per_cloud_threshold_0=all_kept["valid"].sum(1).tolist(),
         labels_kept_threshold_0=per_class, kept_each_class_alone=alone)
    return launches["pillar_canvas_fused"]


def e2e_ms(call):
    """Wall ms per call, each ending with its boxes on the host
    (``bench_lib.wall_seconds``: 2 warm-ups, 10 calls)."""
    from lisec_tpu_torch.bench_lib import wall_seconds
    return 1e3 * wall_seconds(call, 2, 10)


def wire_box_match(a, b, tol=0.05):
    """The JAX package's wire bound on boxes (``tests/test_wire.py``:
    |d| <= 0.05 + 0.05 |b|), box by box: a kept box of one wire matches
    a kept box of the other in the same cloud when every one of its
    seven numbers lies within it. NMS output slots shift when a box near
    the threshold enters or leaves a keep set, so boxes are matched, not
    slots. Returns (boxes of either side without a match, boxes kept on
    both sides, the largest |d| over matched pairs)."""
    unmatched = kept = 0
    worst = 0.0
    for i in range(a["boxes"].shape[0]):
        x = a["boxes"][i][a["valid"][i]]
        y = b["boxes"][i][b["valid"][i]]
        kept += len(x) + len(y)
        if not (len(x) and len(y)):
            unmatched += len(x) + len(y)
            continue
        d = (x[:, None, :] - y[None, :, :]).abs()
        ok = (d <= tol + tol * y.abs()[None]).all(-1)
        unmatched += int((~ok.any(1)).sum()) + int((~ok.any(0)).sum())
        if bool(ok.any()):
            worst = max(worst, float(d.amax(-1)[ok].max()))
    return unmatched, kept, worst


def phase_wire(pipe, cfg):
    """The int16 wire on the main path (trained snapshot, batch 32):
    ``infer_packed`` bit-equal to ``infer`` on the batch it dequantizes
    to, one ``pillar_canvas_fused`` launch; within the JAX package's
    ``tests/test_wire.py`` bounds of the f32 ``infer`` (valid agreement
    above 0.95, boxes 0.05); the card's dequantization bit-equal to the
    CPU's; both wires' host-to-device bytes; the end-to-end ms of both at
    batch 8 and 32, in turns. Returns the launches of one
    ``infer_packed``."""
    import numpy as np
    import torch
    from lisec_tpu_torch.data.wire import pack_points_q16, unpack_points_q16
    batch, _ = scene_batch(cfg, 32)
    packed = pack_points_q16(batch["points"], batch["point_mask"])
    zero_all_launches()
    out = pipe.infer_packed(packed)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != ENCODER_ONLY:
        raise AssertionError(f"infer_packed launched {launches}")
    deq = unpack_points_q16(pipe.device_batch(packed))
    host = unpack_points_q16({k: torch.from_numpy(v)
                              for k, v in packed.items()})
    if not (torch.equal(deq["points"].cpu().view(torch.int32),
                        host["points"].view(torch.int32))
            and torch.equal(deq["point_mask"].cpu(), host["point_mask"])):
        raise AssertionError("the card's dequantization differs from the "
                             "CPU's")
    ref = pipe.infer({k: deq[k] for k in ("points", "point_mask")})
    for k in out:
        if not torch.equal(out[k], ref[k]):
            raise AssertionError(f"infer_packed {k} differs from infer on "
                                 "the dequantized batch")
    f32 = pipe.infer(batch)
    agree = float((f32["valid"] == out["valid"]).float().mean())
    unmatched, kept, box_err = wire_box_match(out, f32)
    if agree <= 0.95 or unmatched > 0.05 * kept:
        raise AssertionError(f"int16 vs f32 wire: valid agreement {agree}, "
                             f"{unmatched} of {kept} boxes unmatched")
    h2d = {"int16": int(sum(np.asarray(v).nbytes for v in packed.values())),
           "f32": int(batch["points"].nbytes + batch["point_mask"].nbytes)}
    times = {}
    for b in (8, 32):
        bb, _ = scene_batch(cfg, b)
        pk = pack_points_q16(bb["points"], bb["point_mask"])
        i1 = e2e_ms(lambda: pipe.infer_packed(pk))
        f1 = e2e_ms(lambda: pipe.infer(bb))
        f2 = e2e_ms(lambda: pipe.infer(bb))
        i2 = e2e_ms(lambda: pipe.infer_packed(pk))
        t0 = time.perf_counter()
        for _ in range(10):
            pack_points_q16(bb["points"], bb["point_mask"])
        times[b] = {"int16_e2e_ms": [i1, i2], "f32_e2e_ms": [f1, f2],
                    "host_pack_ms": (time.perf_counter() - t0) / 10 * 1e3}
    emit("wire", config="pointpillars_kitti", batch=32, launches=launches,
         infer_packed_vs_dequantized_infer="bit-equal",
         card_vs_cpu_dequantization="bit-equal",
         valid_agreement_with_f32=agree, boxes_kept=kept,
         boxes_without_a_match_within_0_05=unmatched,
         matched_box_max_abs_diff=box_err,
         h2d_bytes=h2d, h2d_saved_bytes=h2d["f32"] - h2d["int16"],
         e2e=times)
    return launches["pillar_canvas_fused"]


# What one call of each wrapper launches where the device-time phase
# checks it, by kernel name.
DEVICE_LAUNCHES = {
    "fps": ({"fps_reg_kernel", "fps_smem_kernel"}, 1),
    "pillar_canvas_fused": ({"cells_kernel", "canvas_kernel"}, 2)}


def phase_device_times():
    """The kernels' own time on the card (``device_ms``) of every timed
    ``pillar_canvas_fused``, ``fps``, ``segment_paint``, ``scatter_rows``,
    ``gather_rows``, ``spread_accumulate``, ``threefry`` and unpaint-source
    call (and of
    the ``torch.gather`` beside the plain C = 4 gather), and what it
    launched (``device_parts``), filled into its row; a row that names its
    launches (``expect_launches``) must have launched just those."""
    for kernel, row, call in DEVICE_TIMED:
        row["device_ms"], row["device_parts"] = device_parts(call)
        got = {k.split("<")[0]: p["per_call"]
               for k, p in row["device_parts"].items()}
        if "expect_launches" in row and got != row["expect_launches"]:
            raise AssertionError(f"{kernel} {row.get('entry')} call: "
                                 f"launched {got}, expected "
                                 f"{row['expect_launches']}")
        if kernel in DEVICE_LAUNCHES:
            names, count = DEVICE_LAUNCHES[kernel]
            if not set(got) <= names or sum(got.values()) != count:
                raise AssertionError(f"{kernel} call: launched {got}, "
                                     f"expected {count} of {names}")
        if kernel == "spread_accumulate":
            # A given map: the accumulate alone; else the invert and the
            # accumulate; no memset either way.
            want = {"spread_accumulate_kernel": 1}
            if row["inverse_map"] == "built":
                want["spread_invert_kernel"] = 1
            if got != want:
                raise AssertionError(f"spread call {row['vals']}: launched "
                                     f"{got}, expected {want}")
        emit("device_time", kernel=kernel,
             call={k: row[k] for k in ("entry", "shapes", "out_dtype",
                                       "table", "batch", "points",
                                       "samples", "rows",
                                       "vals", "src", "ids", "table_rows",
                                       "num_rows", "num_out", "num_max",
                                       "split", "dtype", "shape")
                   if k in row},
             ms=row["ms"], device_ms=row["device_ms"],
             device_parts=row["device_parts"],
             library_ms=row["library_ms"], bound_ms=row["bound_ms"])


def phase_profile_listing():
    """Five calls of each wrapper under ``torch.profiler``: the aten ops
    on the host and the kernels on the card. Each call allocates its
    output (``aten::new_empty``, which runs ``aten::empty``; the spread
    without a map its scratch too) and launches its own kernels, and
    nothing else: ``scatter_rows`` at a PointNet++ gradient's shape,
    ``segment_paint`` at the encoder statistics', ``gather_rows`` at a
    feature gather's, the grouping at SA2's (one launch for two gathers,
    the subtraction and the concatenation), ``spread_accumulate`` at a
    level-0 submanifold conv's with its inverse map (one launch) and
    without (the invert and the accumulate, no memset), ``fps_gather`` at
    SA1's (one launch for the picks, their xyz and their mask) and
    ``pillar_canvas_fused`` at a batch-8 KITTI predict's (the cell and
    canvas kernels, no sort, search, gather or memset), the paint and
    the spread at the range-seg predict's shapes (one launch each), and
    the unpaint source's gather (into bf16), segment-max backward and
    decoration at a PointPillars train step's (one launch each)."""
    import torch
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    g = torch.Generator(device="cuda").manual_seed(5)
    vals = torch.randn((16, 8192, 128), generator=g, device="cuda")
    idx = torch.randint(0, 512, (16, 8192), generator=g, device="cuda",
                        dtype=torch.int32)
    rows = torch.randn((4, 32768, 4), generator=g, device="cuda")
    cells = torch.sort(torch.randint(0, NCELLS + 2000, (4, 32768), generator=g,
                                     device="cuda"), 1).values.to(torch.int32)
    feats = torch.randn((16, 512, 128), generator=g, device="cuda")
    xyz = torch.rand((16, 512, 3), generator=g, device="cuda")
    centers = xyz[:, :128].contiguous()
    ids6144 = idx[:, :6144].contiguous()
    nbr = torch.randint(0, 512, (16, 128, 64), generator=g, device="cuda",
                        dtype=torch.int32)
    b, k, n, c = 8, 27, 16000, 16
    stream = torch.randn((b, k, n, c), generator=g,
                         device="cuda").to(torch.bfloat16)
    perm = torch.argsort(torch.rand((b, k, n), generator=g, device="cuda"))
    targets = torch.where(perm < n // 7, perm, -1).to(torch.int32)
    sources = inverse_map(targets, n)
    cloud = torch.rand((16, 2048, 3), generator=g, device="cuda")
    cloud_mask = torch.rand((16, 2048), generator=g, device="cuda") > 0.05
    geo = kitti_geometry()
    pts, pmask = (a.cuda() for a in edge_case_clouds(
        8, 32768, geo, torch.Generator().manual_seed(5)))
    w = torch.randn((9, 64), generator=g, device="cuda")
    t = torch.randn((64,), generator=g, device="cuda")
    # The range-seg predict's two calls: the projection's sum-only paint of
    # 8-channel winner rows and the refinement's K = 1 delivery of 52
    # channels to the first point of each occupied pixel, its map given.
    hw = 64 * 2048
    winner_rows = torch.randn((8, hw, 8), generator=g, device="cuda")
    pixels = torch.sort(torch.randint(0, hw + 20000, (8, hw), generator=g,
                                      device="cuda"), 1).values.to(
        torch.int32)
    window_rows = torch.randn((8, 1, hw, 52), generator=g, device="cuda")
    firsts = torch.argsort(torch.rand((8, 1, hw), generator=g,
                                      device="cuda"))
    firsts = torch.where(firsts < hw // 4, firsts, -1).to(torch.int32)
    first_of = inverse_map(firsts, hw)
    # The unpaint source's three entries at the PointPillars train step's
    # shapes (the gather into bf16, as the densify backward asks).
    table64 = torch.randn((4, NCELLS, 64), generator=g, device="cuda")
    h_bf16 = torch.randn((4, 32768, 64), generator=g,
                         device="cuda").bfloat16()
    stats4 = torch.rand((4, NCELLS, 4), generator=g, device="cuda") * 9
    calls = {
        "fps_gather": (lambda: fk.fps_gather(cloud, cloud_mask, 512),
                       {"fps_reg_kernel": 1}),
        "pillar_canvas_fused": (lambda: ek.pillar_canvas_fused(
            pts, pmask, w, t, **geo), {"cells_kernel": 1,
                                       "canvas_kernel": 1}),
        "scatter_rows": (lambda: gr.scatter_rows(vals, idx, num_rows=512),
                         {"scatter_kernel": 1}),
        "segment_paint": (lambda: sp.segment_paint(
            rows, cells, num_cells=NCELLS, num_max=0),
            {"segment_paint_kernel": 1}),
        "gather_rows": (lambda: gr.gather_rows(feats, ids6144),
                        {"gather_kernel": 1}),
        "group_and_decorate": (lambda: gr.group_and_decorate(
            xyz, feats, centers, nbr), {"group_kernel": 1}),
        "spread_accumulate_given_map": (lambda: sa.spread_accumulate(
            stream, targets, num_out=n, sources=sources),
            {"spread_accumulate_kernel": 1}),
        "spread_accumulate_built_map": (lambda: sa.spread_accumulate(
            stream, targets, num_out=n),
            {"spread_invert_kernel": 1, "spread_accumulate_kernel": 1}),
        "segment_paint_range_projection": (lambda: sp.segment_paint(
            winner_rows, pixels, num_cells=hw, num_max=0),
            {"segment_paint_kernel": 1}),
        "spread_accumulate_knn_delivery": (lambda: sa.spread_accumulate(
            window_rows, firsts, num_out=hw, sources=first_of),
            {"spread_accumulate_kernel": 1}),
        "segment_unpaint_bf16_out": (lambda: su.segment_unpaint(
            table64, cells, out_dtype=torch.bfloat16),
            {"unpaint_kernel": 1}),
        "segment_max_backward": (lambda: su.segment_max_backward(
            h_bf16, cells, table64, table64), {"segmax_backward_kernel": 1}),
        "pillar_decorate": (lambda: su.pillar_decorate(
            rows, cells, stats4, **geo), {"decorate_kernel": 1})}
    for name, (call, want) in calls.items():
        ops, kernels = profiled(call, 5)
        labels = [kernel_label(k) for k, _ in kernels]
        per_call = {w: sum(w in lb for lb in labels) / 5 for w in want}
        emit("profile", kernel=name, calls=5, host_aten_ops=sorted(set(ops)),
             aten_ops_per_call=len(ops) / 5,
             cuda_kernels=sorted(set(labels)),
             launches_caught=len(kernels),
             launches_per_call=per_call)
        # A trace may miss the first launch or two.
        if (set(ops) - {"aten::new_empty", "aten::empty"}
                or any(not any(w in lb for w in want) for lb in labels)
                or any(abs(per_call[w] - want[w]) > 0.4 for w in want)):
            raise AssertionError(f"{name}: 5 calls ran {sorted(set(ops))} "
                                 f"and launched {sorted(set(labels))}")


# -- phase 14: data parallel --------------------------------------------------

# Two gloo ranks on the one card (``--nccl``: one NCCL rank a card under
# torchrun): a check of the DP program (the global batch reductions, the
# gradient sum, infer_dp's gather, point sharding), not of scaling.
# Global batch 8 everywhere, a multiple of the ranks.
DP_RANKS = 2
DP_BATCH = 8
DP_TIMED_STEPS = 3
DP_TINY = (("second_tiny", SECOND_TINY_CFG),
           ("pointnet2_partseg_tiny", PARTSEG_TINY_CFG),
           ("rangeseg_tiny", RANGESEG_TINY_CFG),
           ("pointnet_modelnet40_tiny", POINTNET_CLS_TINY_CFG))
# Part-seg's first set abstraction at full width: 2,048 points, 512
# centres, radius 0.2, 32 neighbours.
DP_FPS = (2048, 512, 0.2, 32)

# Planted faults: one of the port's global batch reductions made
# rank-local, as plain DistributedDataParallel computes it. Each names
# the helper of ``lisec_tpu_torch.parallel.mesh`` that the models and
# losses call, for which ``planted_fault`` swaps in a rank-local
# stand-in: per-rank BatchNorm statistics
# (``global_mean``); a rank's own counts and sums scaled up to the
# global batch (``global_sum``: a local ``num_pos``, cross-entropy
# denominator and SECOND dense-tail BatchNorm, so that the summed shares
# are the mean of the ranks' losses, as DDP averages them); the Lovász
# term of a rank's own pixels (``all_gather``).
PLANTED_FAULTS = {"local_batch_norm": "global_mean",
                  "local_sums": "global_sum",
                  "local_lovasz": "all_gather"}

# The planted faults each DP check is run on: those that change the
# config's step at batch 8 on 2 ranks. Not ``local_sums`` for part-seg:
# every point of its fixture clouds is labelled, so a rank's own count
# of them times the ranks is the global count (``tests/test_torch_dp.py``
# unlabels some points to hold that fault).
DP_FAULTS = {
    "pointpillars_kitti": ("local_batch_norm", "local_sums"),
    "second_tiny": ("local_batch_norm", "local_sums"),
    "pointnet2_partseg_tiny": ("local_batch_norm",),
    "rangeseg_tiny": ("local_batch_norm", "local_sums", "local_lovasz"),
    "pointnet_modelnet40_tiny": ("local_batch_norm",),
}


@contextlib.contextmanager
def planted_fault(kind):
    """Inside the block the port's modules call the rank-local stand-in
    for ``PLANTED_FAULTS[kind]``'s helper: a wrong DP program, which the
    DP checks must fail."""
    from lisec_tpu_torch.parallel import mesh
    name = PLANTED_FAULTS[kind]
    local = {"global_mean": lambda xs, dim: [x.mean(dim=dim) for x in xs],
             "global_sum": lambda x: x * mesh.world_size(),
             "all_gather": lambda x: x}[name]
    helper = getattr(mesh, name)
    users = [m for k, m in list(sys.modules.items())
             if k.startswith("lisec_tpu_torch.") and m is not mesh
             and getattr(m, name, None) is helper]
    for m in users:
        setattr(m, name, local)
    try:
        yield
    finally:
        for m in users:
            setattr(m, name, helper)


def dp_kitti_train_config(num_devices):
    """``pointpillars_kitti.yaml`` at full width (bf16) on the ray-cast
    fixture, batch 8, its own optimizer and schedule (AdamW, onecycle from
    lr / 10), no augmentation, no checkpoint."""
    return train_config(KITTI_CFG, 150000, overrides=(
        "data.fixture=true", "data.fixture_hard=true",
        "data.fixture_size=16", f"train.batch_size={DP_BATCH}",
        f"train.num_devices={num_devices}"))


def dp_tiny_config(path, num_devices):
    from lisec_tpu_torch.config import apply_overrides, load_config
    return apply_overrides(load_config(path), [
        'train.ckpt_dir=""', f"train.batch_size={DP_BATCH}",
        f"train.num_devices={num_devices}"])


def dp_train_batches(pipe, cfg, n):
    from lisec_tpu_torch.data.collate import make_batches
    batches = make_batches(pipe.make_dataset("train"), cfg.budget,
                           cfg.train.batch_size, shuffle=True,
                           seed=cfg.train.seed,
                           augment_fn=pipe.augment_fn("train"))
    return [next(batches) for _ in range(n)]


def dp_steps(pipe, batches):
    """``train_step`` on each batch: per step the aux values, the launches
    and the host time to the card's end; then the state."""
    import torch
    out = []
    for b in batches:
        zero_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = pipe.train_step(b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        out.append(({k: float(v) for k, v in aux.items()}, all_launches(),
                    ms))
    return out, {k: v.to("cpu", copy=True)
                 for k, v in pipe.model.state_dict().items()}


def dp_planted(pipe, name, batches):
    """``dp_steps`` from the config's start again under each of its
    planted faults (``DP_FAULTS``), by fault."""
    from lisec_tpu_torch.weights import load_weights_npz
    out = {}
    for fault in DP_FAULTS[name]:
        pipe.init_state(pipe.cfg.train.seed)
        if name == "pointpillars_kitti":
            load_weights_npz(pipe.model, WEIGHTS)
        with planted_fault(fault):
            out[fault] = dp_steps(pipe, batches)
    return out


def dp_rank(work):
    """One rank of the DP group: ``infer_dp`` of the trained snapshot on
    the 8 scenes, two DP train steps of full-width PointPillars (and
    ``DP_TIMED_STEPS`` more, timed), the gradient bucket's all-reduce
    timed, one DP step of each tiny config, the same steps under each
    planted fault (``dp_planted``), and the point-sharded FPS and ball
    query of one cloud. Returns what it measured, on the host."""
    import torch
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.parallel import (
        all_reduce_grads, ball_query_sharded, fps_sharded)
    from lisec_tpu_torch.weights import load_weights_npz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    pipe = build_model(load_config(KITTI_CFG))
    load_weights_npz(pipe.model, WEIGHTS)
    zero_all_launches()
    res = pipe.infer_dp(work["scenes"])
    torch.cuda.synchronize()
    out["infer_dp"] = ({k: v.cpu() for k, v in res.items()}, all_launches(),
                       pipe.mesh.world)
    del pipe

    cfg = dp_kitti_train_config(0)
    pipe = build_model(cfg)
    pipe.init_state(cfg.train.seed)
    load_weights_npz(pipe.model, WEIGHTS)
    out["kitti_train"] = dp_steps(pipe, work["kitti_batches"][:2])
    out["kitti_timed"] = dp_steps(pipe, work["kitti_batches"][2:])[0]
    out["kitti_faults"] = dp_planted(pipe, "pointpillars_kitti",
                                     work["kitti_batches"][:2])
    params = list(pipe.model.parameters())
    grads = sum(p.grad.numel() for p in params if p.grad is not None)
    all_reduce_grads(params, pipe.mesh)              # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        all_reduce_grads(params, pipe.mesh)
    torch.cuda.synchronize()
    out["bucket"] = (1e3 * (time.perf_counter() - t0) / 5, grads)
    del pipe

    for name, path in DP_TINY:
        cfg = dp_tiny_config(path, 0)
        pipe = build_model(cfg)
        pipe.init_state(cfg.train.seed)
        out[name] = dp_steps(pipe, [work["tiny_batches"][name]])
        out[name + "_faults"] = dp_planted(pipe, name,
                                           [work["tiny_batches"][name]])

    mesh = pipe.mesh
    n = DP_FPS[0] // mesh.world
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    pts = torch.as_tensor(work["cloud"][0][rows], device="cuda")
    msk = torch.as_tensor(work["cloud"][1][rows], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    picks = fps_sharded(pts, msk, DP_FPS[1], mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    centers = torch.as_tensor(work["cloud"][0], device="cuda")[picks.long()]
    nbrs = ball_query_sharded(centers, pts, msk, radius=DP_FPS[2],
                              num_neighbors=DP_FPS[3], mesh=mesh)
    torch.cuda.synchronize()
    out["point_sharded"] = (picks.cpu(), nbrs.cpu(),
                            1e3 * (t1 - t0),
                            1e3 * (time.perf_counter() - t1))
    return out


def dp_pooled_off(a, b, keys):
    """The share of the elements of tensors ``keys`` of two states more
    than 1e-3 apart."""
    import torch
    return float(torch.cat([
        ((a[k].double() - b[k].double()).abs() > 1e-3).reshape(-1)
        for k in keys]).double().mean())


def dp_buffer_gap(a, b, keys):
    """The largest difference of a running statistic in units of its
    BatchNorm's own scale: a mean's over the square root of ``b``'s
    running variance, a variance's over that variance (each plus the
    port's BatchNorm epsilon, 1e-3), so that no statistic near 0 is
    measured relative to itself."""
    gaps = [0.0]
    for k in keys:
        stem, kind = k.rsplit(".", 1)
        var = b[f"{stem}.var"].double() + 1e-3
        scale = {"mean": var.sqrt(), "var": var}[kind]
        gaps.append(float(((a[k].double() - b[k].double()).abs()
                           / scale).max()))
    return max(gaps)


def dp_state_reading(got, want, params, lr, noise=None):
    """The parameters after the steps by ``tests/test_dp.py``'s
    ``close_enough`` (``lr`` the sum of the steps' learning rates: Adam
    moves an element by about its rate a step, whatever its gradient's
    size): every element within 2 lr, and below 1e-4 of all elements
    more than 1e-3 apart, plus 4 times that share between ``noise``'s two
    states (one process on the batch's rows in two orders: the sign flips
    of gradients near 0). The running statistics (``dp_buffer_gap``)
    within 1e-4, plus 4 times their gap between ``noise``'s two. Returns
    each reading beside its limit."""
    import torch
    buffers = [k for k, v in want.items()
               if k not in params and v.is_floating_point()]
    other = dp_buffer_gap(*noise[::-1], buffers) if noise else 0.0
    return {
        "integers_equal": all(torch.equal(got[k], v) for k, v in want.items()
                              if not v.is_floating_point()),
        "params_frac_apart": (
            dp_pooled_off(got, want, params),
            1e-4 + (4 * dp_pooled_off(*noise, params) if noise else 0.0)),
        "params_max_abs_diff": (
            max(float((got[k].double() - want[k].double()).abs().max())
                for k in params), 2 * lr + 1e-4),
        "running_stats_gap": (dp_buffer_gap(got, want, buffers),
                              1e-4 + 4 * other),
        "running_stats_other_order_gap": other,
    }


def dp_aux_reading(got, want, noise=None):
    """Loss and gradient norm relative to one process's, each beside its
    limit: 5e-4, plus 4 times how far one process's moved between
    ``noise``'s two runs (the batch's rows in two orders: the f32 spread
    of the tiny nets)."""
    out = {}
    for k in ("loss", "grad_norm"):
        rtol = 5e-4
        if noise is not None:
            rtol += 4 * abs(noise[1][k] - noise[0][k]) / abs(noise[0][k])
        out[k] = (abs(got[k] - want[k]) / abs(want[k]), rtol)
    return out


def dp_failures(*readings):
    """The (reading, limit) pairs of ``dp_aux_reading`` and
    ``dp_state_reading`` outside their limits."""
    bad = []
    for r in readings:
        for k, v in r.items():
            if v is False or (isinstance(v, tuple) and not v[0] <= v[1]):
                bad.append(f"{k} {v}")
    return bad


def dp_hold(name, readings, planted):
    """Fail unless the DP run's ``readings`` are within their limits and
    every planted fault's (``planted``: fault -> readings) is not.
    Returns them for the ``dp`` line."""
    bad = dp_failures(*readings)
    if bad:
        raise AssertionError(f"dp {name}: {'; '.join(bad)}")
    for fault, r in planted.items():
        if not dp_failures(*r):
            raise AssertionError(f"dp {name}: the planted fault {fault} "
                                 f"passes the DP check: {r}")
    return {"readings": {k: v for r in readings for k, v in r.items()},
            "planted_faults": {
                f: {k: v for x in r for k, v in x.items()}
                for f, r in planted.items()},
            "planted_faults_caught": sorted(planted)}


def no_dropout(pipe):
    for m in pipe.model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0


def dp_reference(cfg, pipe, world):
    """The batches the ranks take (``work``) and one process's results on
    them: ``pipe``'s ``infer`` of the 8 scenes, whole and in the ``world``
    ranks' slices (the card's convolutions may pick another algorithm
    for another batch, and bf16 rounds their sums), two full-width train steps
    from the snapshot on their rows in two orders, each tiny config's
    step (and its noise runs), the part-seg cloud's FPS (kernel and
    plain) and ball query."""
    import torch
    import numpy as np
    from lisec_tpu_torch.api import build_model, infer
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.ops.ball_query import ball_query
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.weights import load_weights_npz
    scenes, _ = scene_batch(cfg, DP_BATCH)
    ref = {"infer": {k: v.cpu() for k, v in infer(pipe, scenes).items()}}
    n = DP_BATCH // world
    rows = [infer(pipe, {k: v[r * n:(r + 1) * n] for k, v in scenes.items()})
            for r in range(world)]
    ref["infer_rows"] = {k: torch.cat([o[k] for o in rows]).cpu()
                         for k in rows[0]}
    tcfg = dp_kitti_train_config(0)
    single = build_model(tcfg)
    single.init_state(tcfg.train.seed)
    load_weights_npz(single.model, WEIGHTS)
    kitti_batches = dp_train_batches(single, tcfg, 2 + DP_TIMED_STEPS)
    ref["lrs"] = [single.schedule(s) for s in range(2)]
    ref["kitti_params"] = {n for n, _ in single.model.named_parameters()}
    perm = np.random.default_rng(0).permutation(DP_BATCH)
    with torch.enable_grad():
        ref["kitti"] = dp_steps(single, kitti_batches[:2])
        ref["kitti_timed"] = dp_steps(single, kitti_batches[2:])[0]
        # The same two steps on the batches' rows in another order: how
        # far one process's own f32 sums (bf16 products) move.
        single.init_state(tcfg.train.seed)
        load_weights_npz(single.model, WEIGHTS)
        ref["kitti_other"] = dp_steps(
            single, [{k: v[perm] for k, v in b.items()}
                     for b in kitti_batches[:2]])
    del single
    tiny_batches = {}
    for name, path in DP_TINY:
        c = dp_tiny_config(path, 0)
        one = build_model(c)
        one.init_state(c.train.seed)
        b = dp_train_batches(one, c, 1)[0]
        tiny_batches[name] = b
        with torch.enable_grad():
            steps, state = dp_steps(one, [b])
            # The spread of one process's f32 sums: the step on the rows
            # in two orders, dropout the identity (another order would
            # move the masks).
            no_dropout(one)
            noise = []
            for rows in (b, {k: v[perm] for k, v in b.items()}):
                one.init_state(c.train.seed)
                noise.append(dp_steps(one, [rows]))
        ref[name] = (steps, state, (noise[0][0][0][0], noise[1][0][0][0]),
                     (noise[0][1], noise[1][1]), one.schedule(0),
                     {n for n, _ in one.model.named_parameters()})
    seg = build_model(dp_tiny_config(PARTSEG_CFG, 0))
    cloud = next(make_batches(seg.make_dataset("test"), seg.cfg.budget, 1,
                              shuffle=False))
    del seg
    cloud = (cloud["points"][0], cloud["point_mask"][0])
    if len(cloud[0]) != DP_FPS[0]:
        raise AssertionError(f"part-seg cloud of {len(cloud[0])} points")
    pts = torch.as_tensor(cloud[0], device="cuda")
    msk = torch.as_tensor(cloud[1], device="cuda")
    kernel = fk.fps(pts[None].contiguous(), msk[None].bool().contiguous(),
                    DP_FPS[1])[0]
    ref["fps"] = (kernel.cpu(), fk.fps_reference(
        pts[None], msk[None].bool(), DP_FPS[1])[0].cpu())
    ref["ball_query"] = ball_query(
        pts[kernel.long()], pts, msk, radius=DP_FPS[2],
        num_neighbors=DP_FPS[3]).cpu()
    torch.cuda.empty_cache()
    work = {"scenes": scenes, "kitti_batches": kitti_batches,
            "tiny_batches": tiny_batches, "cloud": cloud}
    return work, ref


def dp_compare(ranks, ref, backend, whole_batch=True):
    """The ranks' results (``dp_rank``'s, by rank) against one
    process's; prints a ``dp`` line a check and returns rank 0's launches
    by kernel over the DP runs. ``infer_dp`` is held to one process's
    ``infer`` of each rank's rows and, with ``whole_batch``, of the whole
    batch at once."""
    import torch
    world = len(ranks)
    one = ref["infer"]
    for r, rank in enumerate(ranks):
        got, launches, w = rank["infer_dp"]
        if w != world or launches != {**NO_LAUNCHES,
                                      "pillar_canvas_fused": 1}:
            raise AssertionError(f"dp infer_dp rank {r}: world {w}, "
                                 f"launches {launches}")
        same_outputs(got, ref["infer_rows"], f"dp infer_dp rank {r}", 1e-3)
        if whole_batch:
            same_outputs(got, one, f"dp infer_dp rank {r}, whole batch",
                         1e-3)
    emit("dp", check="infer_dp", backend=backend,
         config="pointpillars_kitti", ranks=world, batch=DP_BATCH,
         per_rank=DP_BATCH // world,
         launches_per_rank={"pillar_canvas_fused": 1},
         max_abs_err={k: max(float((rk["infer_dp"][0][k].float()
                                    - ref["infer_rows"][k].float())
                                   .abs().max())
                             for rk in ranks) for k in ("boxes", "scores")},
         max_abs_err_whole_batch={
             k: max(float((rk["infer_dp"][0][k].float()
                           - one[k].float()).abs().max())
                    for rk in ranks) for k in ("boxes", "scores")},
         same_keep_sets_whole_batch=all(
             torch.equal(rk["infer_dp"][0][k], one[k])
             for rk in ranks for k in ("valid", "labels")),
         kept_per_cloud=one["valid"].sum(1).tolist())

    # Two DP train steps of full-width PointPillars.
    per_step = {**NO_LAUNCHES, **POINTPILLARS_LAUNCHES_PER_TRAIN_STEP}
    steps, state = ranks[0]["kitti_train"]
    (want_steps, want_state), other = ref["kitti"], ref["kitti_other"]
    def kitti_readings(run):
        aux = {}
        for i, (s, w, o) in enumerate(zip(run[0], want_steps, other[0])):
            aux.update({f"step_{i + 1}_{k}": v for k, v in
                        dp_aux_reading(s[0], w[0], (w[0], o[0])).items()})
        return aux, dp_state_reading(run[1], want_state, ref["kitti_params"],
                                     sum(ref["lrs"]), (want_state, other[1]))
    for r, rank in enumerate(ranks):
        for s in rank["kitti_train"][0] + rank["kitti_timed"]:
            if s[1] != per_step:
                raise AssertionError(f"dp rank {r} train step launched "
                                     f"{s[1]}, expected {per_step}")
        if any(not torch.equal(v, state[k])
               for k, v in rank["kitti_train"][1].items()):
            raise AssertionError(f"dp rank {r}: state differs from rank 0")
    held = dp_hold("pointpillars_kitti", kitti_readings((steps, state)), {
        f: kitti_readings(run)
        for f, run in ranks[0]["kitti_faults"].items()})
    bucket_ms, grads = ranks[0]["bucket"]
    emit("dp", check="train_steps", backend=backend,
         config="pointpillars_kitti", ranks=world, batch=DP_BATCH, steps=2,
         launches_per_rank_step={k: v for k, v in per_step.items() if v},
         loss=[s[0]["loss"] for s in steps],
         one_process_loss=[w[0]["loss"] for w in want_steps],
         other_order_rel_diff=[
             {k: abs(o[0][k] - w[0][k]) / abs(w[0][k])
              for k in ("loss", "grad_norm")}
             for o, w in zip(other[0], want_steps)],
         lr=ref["lrs"], **held,
         note="a check of the DP program, not a scaling figure"
         + (": the ranks share one card" if backend == "gloo" else ""),
         step_ms_ranks=[max(rk["kitti_timed"][i][2] for rk in ranks)
                        for i in range(DP_TIMED_STEPS)],
         step_ms_one_process=[w[2] for w in ref["kitti_timed"]],
         grad_bucket_all_reduce_ms=bucket_ms,
         grad_bucket_bytes=4 * grads)

    # One DP step of each tiny config.
    under_dp = dict(ranks[0]["infer_dp"][1])
    for s in steps:
        under_dp = {k: under_dp[k] + s[1][k] for k in under_dp}
    for name, _ in DP_TINY:
        (w_steps, w_state, noise, noise_states, lr, params) = ref[name]
        (g_steps, g_state) = ranks[0][name]
        for r, rank in enumerate(ranks):
            if rank[name][0][0][1] != w_steps[0][1]:
                raise AssertionError(
                    f"dp {name} rank {r} launched {rank[name][0][0][1]}, "
                    f"one process {w_steps[0][1]}")

        def readings(run):
            return (dp_aux_reading(run[0][0][0], w_steps[0][0], noise),
                    dp_state_reading(run[1], w_state, params, lr,
                                     noise_states))
        held = dp_hold(name, readings(ranks[0][name]), {
            f: readings(run) for f, run in ranks[0][name + "_faults"].items()})
        under_dp = {k: under_dp[k] + g_steps[0][1][k] for k in under_dp}
        emit("dp", check="tiny_train_step", backend=backend, config=name,
             ranks=world, batch=DP_BATCH, launches_per_rank_step={
                 k: v for k, v in g_steps[0][1].items() if v},
             other_order_rel_diff={
                 k: abs(noise[1][k] - noise[0][k]) / abs(noise[0][k])
                 for k in ("loss", "grad_norm")}, **held)
    # The spread's one caller is range seg's predict (the sparse convs
    # run the fused kernel), which no DP step runs.
    missing = [k for k, v in under_dp.items()
               if not v and k != "spread_accumulate"]
    if missing:
        raise AssertionError(f"dp: no launch of {missing} under DP")

    # Point-axis sharding against the single-device ops.
    kernel, plain = ref["fps"]
    for r, rank in enumerate(ranks):
        picks, got_nbrs = rank["point_sharded"][:2]
        if not (torch.equal(picks, kernel) and torch.equal(picks, plain)):
            raise AssertionError(f"dp fps_sharded rank {r} differs from "
                                 "the single-device FPS")
        if not torch.equal(got_nbrs, ref["ball_query"]):
            raise AssertionError(f"dp ball_query_sharded rank {r} differs "
                                 "from the single-device ball query")
    emit("dp", check="point_sharded", backend=backend, ranks=world,
         points=DP_FPS[0], samples=DP_FPS[1], radius=DP_FPS[2],
         neighbours=DP_FPS[3], fps_equal_kernel_and_plain=True,
         ball_query_equal=True, distinct_picks=len(set(kernel.tolist())),
         fps_sharded_ms=max(rk["point_sharded"][2] for rk in ranks),
         ball_query_sharded_ms=max(rk["point_sharded"][3] for rk in ranks))
    return under_dp


def phase_data_parallel(pipe, cfg):
    """``infer_dp`` at world 1 bit-equal to ``infer`` (one
    ``pillar_canvas_fused`` launch); then two gloo ranks sharing the card
    (``parallel.run_ranks``) against one process on the same batches
    (``dp_compare``): full-width PointPillars ``infer_dp`` (keep sets and
    valid exact, boxes and scores within phase 3's tolerance) and two DP
    train steps (loss and gradient norm within 5e-4, the parameters by
    ``close_enough``, each beside how far one process moves on the rows
    in another order), each rank launching per step what one process
    does; one DP step of each tiny config (the seven kernels between
    them) held the same way; the point-sharded FPS and ball query of a
    full-width part-seg cloud equal to the single-device FPS (kernel and
    plain) and ball query. The step times of the two ranks stand beside
    one process's: a check of the program, not a scaling figure."""
    import torch
    from lisec_tpu_torch.parallel import run_ranks
    t_phase = time.perf_counter()
    scenes, _ = scene_batch(cfg, DP_BATCH)
    zero_all_launches()
    one = pipe.infer(scenes)
    dp1 = pipe.infer_dp(scenes)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != {**NO_LAUNCHES, "pillar_canvas_fused": 2}:
        raise AssertionError(f"infer + infer_dp at world 1 launched "
                             f"{launches}")
    if pipe.mesh.world != 1 or any(not torch.equal(one[k], dp1[k])
                                   for k in one):
        raise AssertionError("infer_dp at world 1 differs from infer")
    emit("dp", check="infer_dp_world_1", config="pointpillars_kitti",
         batch=DP_BATCH, bit_equal=True,
         launches={"pillar_canvas_fused": 1})
    work, ref = dp_reference(cfg, pipe, DP_RANKS)
    t0 = time.perf_counter()
    ranks = run_ranks(dp_rank, DP_RANKS, work)
    spawn_s = time.perf_counter() - t0
    under_dp = dp_compare(ranks, ref, "gloo")
    emit("dp", check="phase", launches_under_dp_rank_0=under_dp,
         spawn_and_ranks_s=spawn_s, phase_s=time.perf_counter() - t_phase)
    return under_dp


def nccl_main(out_dir) -> int:
    """The data-parallel checks of phase 14 on NCCL, one rank a card:

        torchrun --nproc_per_node 4 chip_smoke.py --nccl <shared dir>

    Every rank takes one process's references on its own card first
    (no group is up yet), then the ranks run ``dp_rank``, save what they
    measured to ``<shared dir>``, and rank 0 holds it against its
    references (``dp_compare``)."""
    import torch
    import torch.distributed as dist
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.parallel import initialize_distributed
    from lisec_tpu_torch.weights import load_weights_npz
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    if rank == 0:
        phase_build()
    cfg = load_config(KITTI_CFG)
    pipe = build_model(cfg)
    load_weights_npz(pipe.model, WEIGHTS)
    work, ref = dp_reference(cfg, pipe, int(os.environ["WORLD_SIZE"]))
    del pipe
    initialize_distributed(device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}")
    with torch.enable_grad():
        out = dp_rank(work)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    if rank == 0:
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(dist.get_world_size())]
        under_dp = dp_compare(ranks, ref, "nccl", whole_batch=False)
        emit("dp", check="nccl", ranks=len(ranks),
             cards=torch.cuda.device_count(),
             launches_under_dp_rank_0=under_dp)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# -- the reference's random streams -------------------------------------------

INT_OPS_PER_S = 33.5e12          # F32_FLOPS / 2: one simple instruction a lane
# The threefry kernel's checks: (case, global mask shape, the rows this
# call draws from its first flat index on (None: all of them)).
THREEFRY_CASES = (
    ("partseg_head", (16, 2048, 128), None),
    ("pointnet2_cls_hidden_0", (24, 512), None),
    ("pointnet2_cls_hidden_1", (24, 256), None),
    ("pointnet_cls_hidden_0", (32, 512), None),
    ("pointnet_cls_hidden_1", (32, 256), None),
    ("odd_count", (7, 13), None),
    ("index_past_2_32", (2 ** 32 // 5 + 2, 5), slice(2 ** 32 // 5 - 1,
                                                     2 ** 32 // 5 + 2)),
    ("rank_rows", (16, 2048, 128), slice(8, 16)),
)
# Dropout layers a train step draws a mask for, on the card.
THREEFRY_PER_TRAIN_STEP = {"pointnet2_partseg_fixture_conv": 1,
                           "pointnet2_modelnet40": 2,
                           "pointnet_cls_fixture_conv": 2}
STREAM_TRAIN_STEPS = 2


def threefry_bound_ms(count: int) -> float:
    from lisec_tpu_torch.ops.cuda import threefry as tf
    return 1e3 * max(count * tf.INT_OPS_PER_ELEMENT / INT_OPS_PER_S,
                     count / HBM_BYTES_PER_S)


def phase_threefry_kernel_check():
    """``threefry`` bit-equal to its plain version on the card at part
    seg's and the classifiers' mask shapes, an odd count, a slice whose
    flat index crosses 2**32 and a rank's rows (also equal to those rows
    of the whole mask); each main-path shape timed beside its plain
    version and ``torch.rand`` of the shape (no PyTorch call computes
    threefry; the kernel's own time from ``phase_device_times``). The
    checks' launches do not count. Returns the rows."""
    import math
    import torch
    from lisec_tpu_torch.models.common import dropout_key
    from lisec_tpu_torch.ops.cuda import threefry as tf
    from lisec_tpu_torch.training.loop import step_key
    key = dropout_key(step_key(0, 5), ("Dropout_0",))
    rows = {}
    for case, shape, part in THREEFRY_CASES:
        first = 0 if part is None else part.start
        local = shape if part is None else (part.stop - part.start,
                                            *shape[1:])
        offset = first * math.prod(shape[1:])
        got = tf.bernoulli_mask(key, 0.6, local, offset, "cuda")
        want = tf.bernoulli_mask_reference(key, 0.6, local, offset, "cuda")
        torch.cuda.synchronize()
        if got.dtype != torch.bool or not torch.equal(got, want):
            raise AssertionError(f"threefry {case}: differs from the plain "
                                 "version")
        if case == "rank_rows" and not torch.equal(
                got, tf.bernoulli_mask(key, 0.6, shape, 0, "cuda")[part]):
            raise AssertionError("threefry rank_rows: not the rows of the "
                                 "whole mask")
        share = float(got.float().mean())
        emit("kernel_check", kernel="threefry", case=case,
             shape=list(local), offset=offset, max_abs_err=0.0,
             bit_equal=True, keep_share=share)
        if part is not None or case == "odd_count":
            continue
        count = math.prod(shape)

        def call(shape=shape):
            return tf.bernoulli_mask(key, 0.6, shape, 0, "cuda")
        rows[case] = {
            "shape": list(shape), "elements": count,
            "ms": cuda_ms(call, iters=50),
            "plain_ms": cuda_ms(lambda: tf.bernoulli_mask_reference(
                key, 0.6, shape, 0, "cuda"), iters=5),
            "bound_ms": threefry_bound_ms(count), "bound_by": "operations"
            if count * tf.INT_OPS_PER_ELEMENT / INT_OPS_PER_S
            > count / HBM_BYTES_PER_S else "bytes",
            "library_ms": None,
            "torch_rand_ms": cuda_ms(
                lambda: torch.rand(shape, device="cuda"), iters=50),
            "expect_launches": {"bernoulli_mask_kernel": 1}}
        emit("threefry_kernel", case=case, **rows[case])
        # Its time on the card comes from a trace at the end of the run
        # (phase_device_times), after every timed phase.
        DEVICE_TIMED.append(("threefry", rows[case], call))
    tf.LAUNCHES = 0
    return rows


def phase_init_digests():
    """``init_state(0)`` of every shipped full-width config, drawn on
    this card's host, equal tensor for tensor (SHA-256) to
    ``tests/goldens/torch_init_digests.json``, which the CPU tests hold
    against the JAX package's draw. No kernel runs."""
    import torch
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.weights import state_digests
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_init_digests.json")) as f:
        golden = json.load(f)
    t_phase = time.perf_counter()
    for name, want in golden.items():
        pipe = build_model(load_config(
            os.path.join(ROOT, "configs", f"{name}.yaml")))
        zero_all_launches()
        t0 = time.perf_counter()
        pipe.init_state(0)
        seconds = time.perf_counter() - t0
        launches = all_launches()
        got = state_digests(pipe.model)
        wrong = sorted(k for k in want if got.get(k) != want[k])
        if set(got) != set(want) or wrong:
            raise AssertionError(f"{name}: init_state(0) differs from the "
                                 f"committed digests in {wrong[:5]}")
        if any(launches.values()):
            raise AssertionError(f"{name}: init_state launched {launches}")
        emit("init_digests", config=name, tensors=len(got), equal=True,
             params=sum(p.numel() for p in pipe.model.parameters()),
             init_state_s=seconds)
        del pipe
        torch.cuda.empty_cache()
    emit("init_digests_wall", configs=len(golden),
         seconds=time.perf_counter() - t_phase)


def phase_stream_train_steps():
    """``STREAM_TRAIN_STEPS`` train steps each of full-width part seg
    (batch 16) and PointNet++ cls (batch 24) on the card, the counts set
    to 0 just before and read just after (``THREEFRY_PER_TRAIN_STEP``
    ``threefry`` launches a step, each keyed by the step): every mask the
    kernel drew equal to the plain version's on the same key, shape and
    offset, and a finite loss. Returns the launches by config."""
    import math
    import torch
    import lisec_tpu_torch.models.common as common
    from lisec_tpu_torch.api import build_model
    from lisec_tpu_torch.config import apply_overrides, load_config
    from lisec_tpu_torch.data.collate import make_batches
    from lisec_tpu_torch.ops.cuda import threefry as tf
    drawn = []
    kernel = common.bernoulli_mask

    def recording(key, keep_prob, shape, offset=0, device="cuda"):
        mask = kernel(key, keep_prob, shape, offset, device)
        drawn.append((key, keep_prob, tuple(shape), offset, mask))
        return mask
    out = {}
    for name, cfg in (
            ("pointnet2_partseg_fixture_conv", apply_overrides(
                load_config(PARTSEG_CFG), ['train.ckpt_dir=""'])),
            ("pointnet2_modelnet40", cls_config(POINTNET2_CLS_CFG))):
        pipe = build_model(cfg)
        pipe.init_state(cfg.train.seed)
        batches = make_batches(pipe.make_dataset("train"), cfg.budget,
                               cfg.train.batch_size, shuffle=True,
                               seed=cfg.train.seed,
                               augment_fn=pipe.augment_fn("train"))
        steps = [next(batches) for _ in range(STREAM_TRAIN_STEPS)]
        drawn.clear()
        common.bernoulli_mask = recording
        try:
            zero_all_launches()
            with torch.enable_grad():
                auxes = [pipe.train_step(b) for b in steps]
            torch.cuda.synchronize()
            launches = all_launches()
        finally:
            common.bernoulli_mask = kernel
        want = THREEFRY_PER_TRAIN_STEP[name] * STREAM_TRAIN_STEPS
        if launches["threefry"] != want or len(drawn) != want:
            raise AssertionError(f"{name}: {launches['threefry']} threefry "
                                 f"launches in {STREAM_TRAIN_STEPS} steps, "
                                 f"expected {want}")
        for key, keep, shape, offset, mask in drawn:
            if not torch.equal(mask, tf.bernoulli_mask_reference(
                    key, keep, shape, offset, mask.device)):
                raise AssertionError(f"{name}: a train step's mask differs "
                                     "from the plain version's")
        losses = [float(a["loss"]) for a in auxes]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        emit("stream_train_steps", config=name, steps=STREAM_TRAIN_STEPS,
             launches=launches, masks=[list(d[2]) for d in drawn],
             masks_equal_plain=True, loss=losses)
        out[name] = launches
        del pipe
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.config import apply_overrides
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.ops.cuda import fps as fk
    from lisec_tpu_torch.ops.cuda import gather_rows as gr
    from lisec_tpu_torch.ops.cuda import segment_paint as sp
    from lisec_tpu_torch.ops.cuda import segment_unpaint as su
    from lisec_tpu_torch.ops.cuda import spread_accumulate as sa
    from lisec_tpu_torch.ops.cuda import spread_conv as sc
    from lisec_tpu_torch.ops.cuda import threefry as tf
    from lisec_tpu_torch.weights import load_weights_npz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    gen = torch.Generator().manual_seed(0)

    phase_build()
    phase_kernel_check(gen)
    threefry_rows = phase_threefry_kernel_check()
    phase_init_digests()
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
    phase_centerpoint_serving()
    subm_row = phase_subm_rulebook(second_pipe, second_cfg)
    phase_tiny_vs_cpu("second_tiny", SECOND_TINY_CFG, keep_sets=False)
    train_pipe, train_cfg, train_batch, train_launches = phase_train_path(
        "pointpillars_fixture_hard_conv", TRAIN_CFG, WEIGHTS,
        POINTPILLARS_LAUNCHES_PER_TRAIN_STEP)
    second_train = phase_train_path(
        "second_fixture_conv", SECOND_TRAIN_CFG, None,
        SECOND_LAUNCHES_PER_TRAIN_STEP)
    fp_pipe, fp_cfg, fp_launches, fp_spread_err = phase_footprint_serving(
        gen)
    fp_step_err = phase_footprint_kernel_check()
    fp_train = phase_train_path(
        "second_footprint_conv", SECOND_FOOTPRINT_TRAIN_CFG, None,
        SECOND_LAUNCHES_PER_TRAIN_STEP)
    timing = phase_timing(pipe, cfg)
    second_calls, second_paints = phase_second_timing(second_pipe,
                                                      second_cfg)
    train_rows = phase_train_timing("pointpillars_fixture_hard_conv",
                                    train_pipe, train_cfg, train_batch)
    second_train_rows = phase_train_timing("second_fixture_conv",
                                           *second_train[:3])
    fp_calls, fp_paints = phase_second_timing(fp_pipe, fp_cfg,
                                              "second_kitti_footprint")
    fp_train_rows = phase_train_timing("second_footprint_conv",
                                       *fp_train[:3])
    del fp_pipe
    partseg_cfg = load_config(PARTSEG_CFG)
    partseg_pipe = build_model(partseg_cfg)        # weights from seed 0
    point_err = phase_point_kernel_check(partseg_pipe, partseg_cfg, gen)
    gather_points_row = phase_gather_points(gen)
    partseg_launches = phase_partseg_serving(partseg_pipe, partseg_cfg)
    phase_partseg_tiny_vs_cpu()
    partseg_train = phase_partseg_train()
    fps_rows, gather_rows_, scatter_rows_ = phase_partseg_timing(
        partseg_pipe, partseg_cfg, *partseg_train[:3])
    partseg_train_launches = partseg_train[3]
    msg_cfg = msg_config()
    msg_pipe = build_model(msg_cfg)                # weights from seed 0
    msg_launches = phase_partseg_serving(
        msg_pipe, msg_cfg, "pointnet2_shapenetpart_msg",
        PARTSEG_MSG_LAUNCHES_PER_PREDICT)
    phase_partseg_tiny_vs_cpu("pointnet2_partseg_tiny_msg",
                              ("model.params.msg=true",))
    msg_train = phase_partseg_train(
        PARTSEG_MSG_CFG, MSG_FIXTURE, "pointnet2_shapenetpart_msg",
        PARTSEG_MSG_LAUNCHES_PER_TRAIN_STEP)
    msg_err = phase_msg_kernel_check(msg_pipe, msg_cfg, msg_train[0],
                                     msg_train[2])
    msg_rows = phase_partseg_timing(
        msg_pipe, msg_cfg, *msg_train[:3], "pointnet2_shapenetpart_msg",
        calls=(2, 7, 4), groupings=5)
    msg_train_launches = msg_train[3]
    if msg_launches != PARTSEG_MSG_LAUNCHES_PER_PREDICT:
        raise AssertionError(f"msg predict launches {msg_launches}")
    del msg_pipe, msg_train
    rangeseg_cfg = rangeseg_config()
    rangeseg_pipe = build_model(rangeseg_cfg)      # weights from seed 0
    rangeseg_err = phase_rangeseg_kernel_check(rangeseg_pipe, rangeseg_cfg)
    rangeseg_launches = phase_rangeseg_serving(rangeseg_pipe, rangeseg_cfg)
    phase_rangeseg_tiny_vs_cpu()
    rangeseg_train = phase_rangeseg_train()
    rangeseg_fixture, rangeseg_scan, rangeseg_train_paint = \
        phase_rangeseg_timing(rangeseg_pipe, rangeseg_cfg,
                              rangeseg_train[0], rangeseg_train[2])
    pn_pipe, pn_cfg, pn_first = phase_pointnet_cls()
    (pn2_pipe, pn2_cfg, pn2_first, cls_predict_launches,
     cls_train_launches, cls_err) = phase_pointnet2_cls()
    stream_launches = phase_stream_train_steps()
    phase_evaluate(partseg_pipe, rangeseg_pipe, pn_pipe, pn2_pipe)
    cls_rows = phase_cls_timing((
        ("pointnet_cls_fixture_conv", pn_pipe, pn_cfg, pn_first),
        ("pointnet2_modelnet40", pn2_pipe, pn2_cfg, pn2_first)))
    with tempfile.TemporaryDirectory() as tmp:
        shipped = phase_configs_as_written(tmp)
    vb_cfg = apply_overrides(load_config(KITTI_CFG), list(VOXEL_BUFFER))
    vb_pipe = build_model(vb_cfg)                  # weights from seed 0
    table_calls = phase_voxel_table_kernel_check(vb_pipe, vb_cfg)
    vb_launches, vb_rows = phase_voxel_buffer_path(
        vb_pipe, vb_cfg, build_model(load_config(KITTI_CFG)), pipe,
        table_calls)
    phase_tiny_vs_cpu("pointpillars_tiny_voxel_buffer", TINY_CFG,
                      keep_sets=True, overrides=VOXEL_BUFFER)
    vb_name = "pointpillars_fixture_hard_conv_voxel_buffer"
    vb_train = phase_train_path(vb_name, TRAIN_CFG, None,
                                VOXEL_BUFFER_LAUNCHES_PER_TRAIN_STEP,
                                overrides=VOXEL_BUFFER)
    vb_train_rows = phase_train_timing(vb_name, *vb_train[:3])
    three_class_launches = phase_three_class()
    packed_launches = phase_wire(pipe, cfg)
    phase_profile_listing()
    phase_device_times()
    under_dp = phase_data_parallel(pipe, cfg)

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

    # The encoder: the call of a batch-8 predict (two kernel launches, by
    # name in device_parts); batch 32's call beside it.
    kernels = [{
        **ek.KERNEL_INFO, "launches": launches, "max_abs_err": err,
        **{k: timing[8][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "device_ms",
                                      "device_parts")},
        "kernel_launches_per_call": 2, "batch_32": timing[32],
        "launches_cli_infer_from_checkpoint": shipped["cli_launches"],
        "launches_per_voxel_buffer_predict":
            vb_launches["pillar_canvas_fused"],
        "launches_per_infer_packed": packed_launches,
        "launches_per_three_class_predict": three_class_launches}]
    # The segment kernels: the times of one PointPillars train step's
    # calls together (three paints; the unpaint source's decoration and
    # segment-max backward), each call also on its own under "calls". No
    # single PyTorch call computes a table of max and sum channels, so the
    # paint's library time stands only with its all-sum call. Their calls
    # in a SECOND train step stand beside them, and the paint's two calls
    # of a SECOND predict at batch 8.
    # The paint's and the spread's calls of a range-seg predict at batch 8
    # (fixture density and a scan's 120,000 points) and the paint's of a
    # range-seg train step stand beside them too.
    def rangeseg(name):
        i = ("segment_paint", "spread_accumulate").index(name)
        return {
            "launches_per_rangeseg_predict": rangeseg_launches[name],
            "launches_per_rangeseg_train_step":
                rangeseg_train[3][name] / TRAIN_STEPS,
            "rangeseg_max_abs_err": rangeseg_err[name],
            "rangeseg_predict": rangeseg_fixture[i][0],
            "rangeseg_predict_120k_points": rangeseg_scan[i][0],
            **({"rangeseg_train_step": rangeseg_train_paint}
               if i == 0 else {})}

    def written(name):
        return {f"launches_per_train_step_as_written_{cfg_name}": per[name]
                for cfg_name, per in
                shipped["launches_per_train_step"].items()}

    for mod in (sp, su):
        name = mod.KERNEL_INFO["name"]
        kernels.append({
            **mod.KERNEL_INFO, "launches": train_launches[name],
            **written(name),
            "max_abs_err": seg_err[name], **summed(train_rows[name]),
            "launches_per_train_step": train_launches[name] / TRAIN_STEPS,
            "launches_per_second_predict": second_launches[name],
            "launches_per_second_train_step":
                second_train[3][name] / TRAIN_STEPS,
            "calls": train_rows[name],
            "second_train_step": summed(second_train_rows[name]),
            **({"second_train_step_calls": second_train_rows[name],
                "second_train_step_write_floor_ms": sum(
                    c["write_floor_ms"] for c in second_train_rows[name])}
               if mod is su else {}),
            **({"second_predict": summed(second_paints),
                "second_predict_calls": second_paints, **rangeseg(name),
                # The voxel-buffer PointPillars: the voxel table's call
                # at batch 8 and 32 (bit-equal to the plain version).
                "launches_per_voxel_buffer_predict":
                    vb_launches["segment_paint"],
                "voxel_table_max_abs_err": 0.0,
                "voxel_table_batch_8": vb_rows[8],
                "voxel_table_batch_32": vb_rows[32],
                # The submanifold rulebook's inverses at SECOND's level 0.
                "launches_per_subm_rulebook": 1,
                "subm_inverse_max_abs_err": subm_row["max_abs_err"],
                "subm_inverse": subm_row}
               if mod is sp else {}),
            # SECOND with the footprint downsample: its predict's and
            # train step's calls beside dilate's.
            "launches_per_footprint_predict": fp_launches[name],
            "launches_per_footprint_train_step":
                fp_train[3][name] / TRAIN_STEPS,
            "footprint_max_abs_err": fp_step_err[name],
            "footprint_train_step": summed(fp_train_rows[name])
            if fp_train_rows[name] else None,
            **({"footprint_predict": summed(fp_paints)}
               if mod is sp else {}),
            "launches_per_voxel_buffer_train_step":
                vb_train[3][name] / TRAIN_STEPS,
            "voxel_buffer_train_step": summed(vb_train_rows[name])
            if vb_train_rows[name] else None})
    # The spread kernel: range seg's kNN delivery is its caller on the
    # main paths; its checks on SECOND's rulebooks (random streams) beside
    # it.
    name = sa.KERNEL_INFO["name"]
    kernels.append({
        **sa.KERNEL_INFO, "launches": rangeseg_launches[name],
        "max_abs_err": max(spread_err, fp_spread_err),
        "launches_per_second_predict": second_launches[name],
        "launches_per_second_train_step":
            second_train[3][name] / TRAIN_STEPS,
        **rangeseg(name)})
    # The sparse convs' fused kernel: the nine calls of one SECOND predict
    # at batch 8 together; the nine of a train step at batch 4 and the
    # footprint variant's beside them; the largest difference from the
    # pair it replaced over every check, as a share of its tolerance.
    name = sc.KERNEL_INFO["name"]
    kernels.append({
        **sc.KERNEL_INFO, "launches": second_launches[name],
        "checks": len(SPCONV_CHECKS),
        "largest_share_of_tolerance": max(
            r["largest_share_of_tolerance"] for r in SPCONV_CHECKS),
        **summed(second_calls),
        "launches_per_predict": second_launches[name],
        "invert_launches_per_predict": second_launches["spread_invert"],
        "launches_per_train_step": second_train[3][name] / TRAIN_STEPS,
        **written(name),
        "calls": second_calls,
        "second_train_step": summed(second_train_rows[name]),
        "launches_per_footprint_predict": fp_launches[name],
        "launches_per_footprint_train_step": fp_train[3][name] / TRAIN_STEPS,
        "footprint_max_abs_diff_from_pair": fp_step_err[name],
        "footprint_predict": summed(fp_calls),
        "footprint_calls": fp_calls,
        "footprint_train_step": summed(fp_train_rows[name])})
    # The point kernels: FPS and the gathers as the calls of one PointNet++
    # predict at batch 16 together, the scatters as the three of one train
    # step at batch 16 (the gathers' backward). The calls of a PointNet2Cls
    # predict at batch 24 (the scatter's: of its train step) beside them.
    for info, rows, launches_, err_, cls, msg in (
            (fk.KERNEL_INFO, fps_rows, partseg_launches["fps"],
             point_err["fps"], cls_rows[0], msg_rows[0]),
            (gr.GATHER_INFO, gather_rows_, partseg_launches["gather_rows"],
             point_err["gather_rows"], cls_rows[1], msg_rows[1]),
            (gr.SCATTER_INFO, scatter_rows_,
             partseg_train_launches["scatter_rows"],
             point_err["scatter_rows"], cls_rows[2], msg_rows[2])):
        name = info["name"]
        kernels.append({
            **info, "launches": launches_, "max_abs_err": err_,
            **summed(rows),
            "launches_per_predict": PARTSEG_LAUNCHES_PER_PREDICT[name],
            "launches_per_train_step":
                partseg_train_launches[name] / TRAIN_STEPS,
            **({"round_floor_ms": sum(c["round_floor_ms"] for c in rows)}
               if info is fk.KERNEL_INFO else {}),
            "calls": rows,
            "launches_per_cls_predict": cls_predict_launches[name],
            "launches_per_cls_train_step":
                cls_train_launches[name] / TRAIN_STEPS,
            "cls_max_abs_err": cls_err[name],
            ("cls_train_step" if info is gr.SCATTER_INFO
             else "cls_predict"): summed(cls),
            "cls_calls": cls,
            # PointNet++ MSG part seg: its predict's (the scatter's: its
            # train step's) calls.
            "launches_per_msg_predict":
                PARTSEG_MSG_LAUNCHES_PER_PREDICT[name],
            "launches_per_msg_train_step":
                msg_train_launches[name] / TRAIN_STEPS,
            "msg_max_abs_err": msg_err[name],
            ("msg_train_step" if info is gr.SCATTER_INFO
             else "msg_predict"): summed(msg),
            "msg_calls": msg,
            **({"launches_per_gather_points": 1,
                "gather_points_max_abs_err":
                    gather_points_row["max_abs_err"],
                "gather_points": gather_points_row}
               if info is gr.GATHER_INFO else {})})
    # threefry: the part-seg head's mask (16, 2048, 128) timed; the
    # classifiers' hidden layers' beside it. Its launches are those of
    # the train steps of phase_stream_train_steps.
    head = threefry_rows["partseg_head"]
    kernels.append({
        **tf.KERNEL_INFO,
        "launches": sum(v["threefry"] for v in stream_launches.values()),
        "launches_by_config": {k: v["threefry"]
                               for k, v in stream_launches.items()},
        "max_abs_err": 0.0,
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms", "device_parts",
                                "torch_rand_ms", "shape")},
        "launches_per_train_step": THREEFRY_PER_TRAIN_STEP,
        "launches_per_msg_train_step":
            msg_train_launches["threefry"] / TRAIN_STEPS,
        "launches_per_predict": 0,
        "cls_calls": {k: v for k, v in threefry_rows.items()
                      if k != "partseg_head"}})
    for k in kernels:
        k["launches_under_dp_rank_0"] = under_dp[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

def centerpoint_main() -> int:
    """``--centerpoint``: the build, the fused sparse conv's edge cases
    and phase 5's CenterPoint serving alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    phase_build()
    phase_spread_conv_edges(torch.Generator().manual_seed(0))
    phase_centerpoint_serving()
    print(CARD)
    return 0


# -- the NMS rounds' kernel ---------------------------------------------------

NMS_CELLS = ("pp_serve_b32", "second_serve_b8", "centerpoint_serve_b4")


def nms_gap(args, kw, a, b):
    """Where two outputs of the rounds differ: the smallest |IoU - iou
    threshold| of rotated_iou_bev over the pairs (box emitted by either,
    candidate of its key) of the streams that differ, both orders; None
    where they are equal."""
    import torch
    from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev
    alive, scores, boxes, keys, hd = args
    bad = ~((a[0] == b[0]) & (a[1] == b[1])).all(dim=1)
    if not bad.any():
        return None
    gaps = []
    for s in torch.nonzero(bad).flatten().tolist():
        em = torch.unique(torch.cat([a[0][s][a[1][s]], b[0][s][b[1][s]]]))
        if em.numel() == 0:
            continue
        eb, cb = boxes[s, em], boxes[s]
        same = keys[s, em][:, None] == keys[s][None, :]
        for iou in (rotated_iou_bev(eb[:, None], cb[None]),
                    rotated_iou_bev(cb[None], eb[:, None])):
            gaps.append(float((iou - kw["iou_threshold"]).abs()[same].min()))
    return min(gaps) if gaps else float("inf")


def check_nms_call(args, kw, got, what):
    """The kernel's outputs of one call of the rounds against the plain
    version's on the card: equal, or every difference within the IoU's
    sum-order tolerance of the threshold. Returns the fields of its
    ``kernel_check`` line."""
    from lisec_tpu_torch.ops import nms as nms_mod
    from lisec_tpu_torch.ops.cuda import rotated_nms as nk
    want = nms_mod._run_streams(*args, **kw)
    gap = nms_gap(args, kw, got, want)
    if gap is not None and gap > nk.IOU_SUM_ORDER_TOL:
        raise AssertionError(f"{what}: the kernel's keep sets differ from "
                             f"the plain version's, nearest IoU {gap} from "
                             f"the threshold")
    return {"equal": gap is None, "closest_gap": gap,
            "emitted": int(want[1].sum()), "emitted_kernel": int(got[1].sum())}


def nms_call_fields(args, kw):
    s, p = args[0].shape
    return {"streams": s, "pre": p, "block": kw["block"],
            "k_near": 0 if kw["full"] else kw["k_near"],
            "post": kw["nms_post"], "iou": kw["iou_threshold"],
            "key": str(args[3].dtype).replace("torch.", "")}


class NMSRecorder:
    """While entered, records every call of the rounds
    (``nms_kernel.run_streams``: inputs cloned, keywords, outputs) and of
    the pipelines' ``rotated_nms`` (inputs and keywords)."""

    def __enter__(self):
        from lisec_tpu_torch.ops import nms as nms_mod
        from lisec_tpu_torch.pipelines import detection
        self.rounds, self.calls = [], []
        self._rs = nms_mod.nms_kernel.run_streams
        self._nms = detection.rotated_nms

        def rounds(*a, **kw):
            out = self._rs(*a, **kw)
            self.rounds.append(([x.clone() for x in a], dict(kw), out))
            return out

        def call(*a, **kw):
            self.calls.append((a, dict(kw)))
            return self._nms(*a, **kw)
        nms_mod.nms_kernel.run_streams = rounds
        detection.rotated_nms = call
        return self

    def __exit__(self, *exc):
        from lisec_tpu_torch.ops import nms as nms_mod
        from lisec_tpu_torch.pipelines import detection
        nms_mod.nms_kernel.run_streams = self._rs
        detection.rotated_nms = self._nms
        return False


def plain_rounds():
    """A context in which ``rotated_nms`` runs the rounds' plain version
    on the card."""
    import contextlib
    from lisec_tpu_torch.ops import nms as nms_mod

    @contextlib.contextmanager
    def swapped():
        real = nms_mod.nms_kernel.run_streams
        nms_mod.nms_kernel.run_streams = nms_mod._run_streams
        try:
            yield
        finally:
            nms_mod.nms_kernel.run_streams = real
    return swapped()


def phase_nms_cells(seed=2**31 + 22):
    """Each serving cell of the benchmark set up as its run sets it up
    (configuration, weights, traffic from ``seed``); each of its distinct
    batches through ``infer_packed``, every call of the rounds held
    against the plain version on the card (``kernel_check`` lines), and
    the whole predict against the predict with the plain rounds (boxes,
    scores, labels and ``valid`` equal); one ``rotated_nms`` call a
    predict, one launch a call, and no host synchronisation inside it
    (``torch.cuda.set_sync_debug_mode("error")``); then at each cell's
    shape the kernel alone, the plain loop, and the whole ``rotated_nms``
    with either (``nms_kernel`` lines)."""
    import torch
    from portbench.harness.spec import load_cell
    from lisec_tpu_torch.data.wire import pack_points_q16
    from lisec_tpu_torch.ops import nms as nms_mod
    from lisec_tpu_torch.ops.cuda import build
    from lisec_tpu_torch.ops.cuda import rotated_nms as nk
    smem = build.bind("rotated_nms", "lisec_rotated_nms_smem", [])
    smem.argtypes = [ctypes.c_longlong] * 5
    smem.restype = ctypes.c_longlong
    for name in NMS_CELLS:
        cell = load_cell(name)
        loop = cell.loop(cell, seed, "cuda")
        loop.setup()
        pipe = loop.pipeline
        for bid, (_, pts, mask) in enumerate(loop.batches):
            packed = pack_points_q16(pts, mask)
            n0 = nk.LAUNCHES
            with NMSRecorder() as rec:
                out = pipe.infer_packed(packed)
            torch.cuda.synchronize()
            launches = nk.LAUNCHES - n0
            if len(rec.calls) != 1 or len(rec.rounds) != 1 or launches != 1:
                raise AssertionError(
                    f"{name} batch {bid}: {len(rec.calls)} rotated_nms "
                    f"calls, {len(rec.rounds)} rounds calls, {launches} "
                    f"launches; expected one each")
            args, kw, got = rec.rounds[0]
            row = check_nms_call(args, kw, got, f"{name} batch {bid}")
            with plain_rounds():
                plain = pipe.infer_packed(packed)
            same = all(torch.equal(out[k], plain[k])
                       for k in ("boxes", "scores", "labels", "valid"))
            if row["equal"] and not same:
                raise AssertionError(f"{name} batch {bid}: the rounds agree "
                                     f"but the predicts do not")
            a, k = rec.calls[0]
            torch.cuda.set_sync_debug_mode("error")
            try:
                nms_mod.rotated_nms(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            emit("kernel_check", kernel="rotated_nms", case=name, batch=bid,
                 predict_equal=same, launches_per_predict=launches,
                 **nms_call_fields(args, kw), **row)
        # Timings at the cell's shape: its first batch.
        with NMSRecorder() as rec:
            packed = pack_points_q16(*loop.batches[0][1:])
            pipe.infer_packed(packed)
        args, kw, _ = rec.rounds[0]
        a, k = rec.calls[0]
        s, p = args[0].shape
        key_bytes = args[3].element_size()
        nbytes = nk.bound_bytes(s, p, kw["nms_post"], key_bytes)
        # CUDA events around the host-paced plain loop time its wall
        # clock too: the stream idles while the host issues a round.
        ms = cuda_ms(lambda: nk.run_streams(*args, **kw), 50)
        _, parts = device_parts(lambda: nk.run_streams(*args, **kw))
        parts = {n: v for n, v in parts.items() if not n.startswith("lisec.")}
        dev_ms = sum(v["ms"] * v["per_call"] for v in parts.values())
        plain_ms = cuda_ms(lambda: nms_mod._run_streams(*args, **kw), 5)
        nms_ms = cuda_ms(lambda: nms_mod.rotated_nms(*a, **k), 20)
        with plain_rounds():
            nms_plain_ms = cuda_ms(lambda: nms_mod.rotated_nms(*a, **k), 5)
        emit("nms_kernel", cell=name, **nms_call_fields(args, kw), ms=ms,
             device_ms=dev_ms, parts=parts, plain_ms=plain_ms,
             rotated_nms_ms=nms_ms, rotated_nms_plain_ms=nms_plain_ms,
             bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
             smem_bytes=smem(p, kw["block"], 0 if kw["full"] else
                             kw["k_near"], int(kw["full"]), key_bytes))
        loop.release()
        del loop, pipe
        torch.cuda.empty_cache()


def nms_grid_inputs(gen, pre, variant):
    """Two clouds of pre + 64 clustered boxes (exact duplicates among
    them) with scores on a grid of 1/50, for ``rotated_nms``: 3 classes;
    with ``groups`` 2 groups over 6 labels."""
    import torch
    b, a = 2, pre + 64
    centres = torch.rand(b, 8, 2, generator=gen) * 60
    pick = torch.randint(0, 8, (b, a), generator=gen)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(b, a, 2, generator=gen) * 1.5
    size = 1.0 + torch.rand(b, a, 3, generator=gen) * 3
    yaw = (torch.rand(b, a, 1, generator=gen) - 0.5) * 6.3
    boxes = torch.cat([xy, torch.zeros(b, a, 1), size, yaw], dim=-1)
    boxes[:, 1::5] = boxes[:, 0::5][:, :boxes[:, 1::5].shape[1]]
    scores = torch.round(torch.rand(b, a, generator=gen) * 50) / 50
    labels = torch.randint(0, 6 if variant == "groups" else 3, (b, a),
                           generator=gen).int()
    kw = {}
    if variant == "class_parallel":
        kw["class_parallel"] = 3
    elif variant == "groups":
        kw.update(groups=(labels % 2).long().cuda(), class_parallel=2)
    return boxes.cuda(), scores.cuda(), labels.cuda(), kw


def phase_nms_grid():
    """The kernel against the plain version on clustered random boxes:
    pre 64, 1,024, 3,000 and 4,096; k_near 0 (full rows), 8 and 64;
    block 4 and 16; one stream a cloud, one a class, one a group; IoU
    thresholds 0.2 and 0.5 (``kernel_check`` lines with a ``grid``
    case)."""
    import itertools
    import torch
    from lisec_tpu_torch.ops import nms as nms_mod
    gen = torch.Generator().manual_seed(22)
    flipped = 0
    for pre, k_near, block, variant, thr in itertools.product(
            (64, 1024, 3000, 4096), (0, 8, 64), (4, 16),
            ("one_stream", "class_parallel", "groups"), (0.2, 0.5)):
        boxes, scores, labels, extra = nms_grid_inputs(gen, pre, variant)
        with NMSRecorder() as rec:
            out = nms_mod.rotated_nms(
                boxes, scores, labels, iou_threshold=thr,
                score_threshold=0.1, nms_pre=pre, nms_post=64, block=block,
                k_near=k_near, **extra)
        args, kw, got = rec.rounds[0]
        row = check_nms_call(args, kw, got, f"grid {pre} {k_near} {block} "
                             f"{variant} {thr}")
        flipped += not row["equal"]
        if row["emitted"] < 8:
            raise AssertionError(f"grid {pre} {k_near} {block} {variant}: "
                                 f"only {row['emitted']} kept")
        emit("kernel_check", kernel="rotated_nms", case="grid",
             variant=variant, kept=int(out.valid.sum()),
             **nms_call_fields(args, kw), **row)
    emit("nms_grid", configs=144, differing=flipped)


def nms_main() -> int:
    """``--nms``: the build and the NMS rounds' kernel alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    phase_build()
    phase_nms_grid()
    phase_nms_cells()
    print(CARD)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl"]:
        sys.exit(nccl_main(sys.argv[2]))
    if sys.argv[1:2] == ["--centerpoint"]:
        sys.exit(centerpoint_main())
    if sys.argv[1:2] == ["--nms"]:
        sys.exit(nms_main())
    sys.exit(main())
