#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lisec_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it goes wrong:

1. build every CUDA kernel of the main path from ``lisec_tpu_torch/csrc``
   with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version on the card, on
   random clouds at KITTI geometry plus edge cases;
3. drive the main path: full-width PointPillars inference
   (``configs/pointpillars_kitti.yaml``, bf16) with the trained snapshot
   ``weights/pointpillars_fixture_hard.npz`` on 8 ray-cast scenes, with
   the launch counts set to 0 just before and read just after; check the
   outputs, and that the kernel path and the plain encoder agree; check
   the small ``pointpillars_tiny`` predict on the card against the CPU;
4. time the predict at batch 8 and 32, and the kernel, its plain version
   and its glue at the main path's shapes, with CUDA events;
5. print the ``{"kernels": [...]}`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the rest of the repository; without either it
exits nonzero before printing any result.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_CFG = os.path.join(ROOT, "configs", "pointpillars_kitti.yaml")
TINY_CFG = os.path.join(ROOT, "configs", "pointpillars_tiny.yaml")
WEIGHTS = os.path.join(ROOT, "weights", "pointpillars_fixture_hard.npz")
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
    from lisec_tpu_torch.ops.cuda import build
    res = build.build("encoder_kernel")
    ptxas = [ln.strip() for ln in res["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="encoder_kernel", seconds=res["seconds"],
         ptxas=ptxas)


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


def phase_tiny_vs_cpu():
    """The small config on the card against the same on the CPU (the
    CPU path is the one the tests hold against the JAX package)."""
    import torch
    from lisec_tpu_torch.api import build_model, infer, load_config
    from lisec_tpu_torch.config import apply_overrides
    # Score threshold 0: the random weights' scores sit near the head's
    # prior, and every candidate then goes through NMS.
    cfg = apply_overrides(load_config(TINY_CFG),
                          ["model.params.score_threshold=0.0"])
    batch, _ = scene_batch(cfg, 4)
    outs = [{k: v.cpu() for k, v in infer(build_model(cfg, d), batch,
                                           d).items()}
            for d in ("cuda", "cpu")]
    same_outputs(outs[0], outs[1], "pointpillars_tiny cuda vs cpu", 1e-4)
    emit("tiny_vs_cpu", kept_per_cloud=outs[0]["valid"].sum(1).tolist())


# -- phase 4 ----------------------------------------------------------------

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lisec_tpu_torch.api import build_model, load_config
    from lisec_tpu_torch.ops.cuda import encoder_kernel as ek
    from lisec_tpu_torch.weights import load_weights_npz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    global CARD
    CARD = card()
    gen = torch.Generator().manual_seed(0)

    phase_build()
    phase_kernel_check(gen)
    cfg = load_config(KITTI_CFG)
    pipe = build_model(cfg)
    load_weights_npz(pipe.model, WEIGHTS)
    launches, err = phase_main_path(pipe, cfg)
    phase_tiny_vs_cpu()
    timing = phase_timing(pipe, cfg)

    print(json.dumps({"kernels": [{
        **ek.KERNEL_INFO, "launches": launches, "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
