"""CenterPoint inference in plain PyTorch, float32, for the reference.

Yin, Zhou and Kraehenbuehl, "Center-based 3D Object Detection and
Tracking", CVPR 2021, with the voxel network of OpenPCDet's
``tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml``:

* voxels of the mean of their first ``max_points_per_voxel`` points
  (every channel, the time lag too), the ``max_voxels`` lowest cell ids;
* ``VoxelResBackBone8x`` on spconv's sparse shape (the voxel grid with
  one z layer more): a submanifold 3^3 conv into 16 channels, BatchNorm,
  ReLU; at each of 16, 32, 64 and 128 channels two ``SparseBasicBlock``s
  (submanifold conv with a bias, BatchNorm, ReLU, the same again without
  the ReLU, the block's input added, ReLU); between levels a strided
  3^3 conv of stride 2 and padding 1, (0, 1, 1) into 128 channels; then
  ``conv_out``, kernel (3, 1, 1), stride (2, 1, 1), padding 0. A strided
  conv's output set is spconv's: every cell with an input under one of
  its taps;
* ``HeightCompression``: the dense (C, D, H, W) map as (C * D, H, W),
  channel ``c * D + d``;
* the BEV backbone and neck (``pointpillars.backbone``);
* ``CenterHead``: a shared 3x3 conv with a bias, BatchNorm, ReLU; per
  task six heads, each a 3x3 conv with a bias, BatchNorm, ReLU and a 3x3
  conv with a bias to its outputs (centre offset 2, height 1, log size 3,
  heading cos and sin 2, velocity 2, the task's class heatmaps);
* per task: the top ``max_obj_per_sample`` of the sigmoid heatmap over
  classes and cells (ties to the lower index), centres
  ``(cell + offset) * 8 * voxel + range low``, sizes ``exp``, heading
  ``atan2(sin, cos)``; scores above ``score_threshold`` with their centre
  inside ``post_center_range``; greedy rotated NMS over the task's
  candidates whatever their class (``detect.greedy_nms``), at most
  ``nms_post`` kept.

Departures from the source, which the configuration's ``assumed`` states
too: the neck's stride-1 up branch is a 3x3 conv, not a 1x1 transposed
conv, and the backbone's convs pad as flax's ``SAME`` (the program's
shared ``BEVBackbone``); the levels 1-3 and ``conv_out`` have static
list budgets (the lowest cell ids kept), which spconv does not; each
kept box suppresses only its ``nms_near`` nearest candidates of its task
(the program's NMS reach).

Each sparse conv is written gather-form: for every output cell and tap,
the input row found by a binary search over the level's sorted cell
ids. The weights are a flat dict of ``params/...`` and ``batch_stats/...``
arrays under the program's module paths (``encoder/sparse/<i>``,
``BEVBackbone_0/...``, ``head/shared``, ``head/tasks/<t>/<head>/conv``
and ``/out``), 2D kernels (kh, kw, in, out), sparse kernels (taps, in,
out). Nothing here uses the port.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import detect, exact_float32
from portbench.reference.pointpillars import Cast, _bn, _same, backbone
from portbench.reference.second import _lin, voxelize_mean

SUBM = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
DOWN = (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (0, 1, 1)))
CONV_OUT = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
HEADS = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2),
         ("vel", 2), ("hm", None))
OUTPUT_STRIDE = 8


def sparse_shape(cfg: Dict) -> Tuple[int, int, int]:
    """(nz + 1, ny, nx): spconv's ``grid_size[::-1] + [1, 0, 0]``."""
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    nx, ny, nz = (int(round((r[i + 3] - r[i]) / vs[i])) for i in range(3))
    return nz + 1, ny, nx


def grid_out(grid, kernel, stride, pad) -> Tuple[int, int, int]:
    return tuple((g + 2 * p - k) // s + 1
                 for g, k, s, p in zip(grid, kernel, stride, pad))


def taps(kernel) -> List[Tuple[int, int, int]]:
    return list(itertools.product(*(range(k) for k in kernel)))


def output_set(coords: torch.Tensor, grid_in, kernel, stride, pad,
               budget: int):
    """Output cells of a strided conv: every cell ``o`` with an input at
    ``o * stride - pad + tap`` for some tap, the ``budget`` lowest ids
    kept. Returns (coords (V', 3), the output grid)."""
    go = grid_out(grid_in, kernel, stride, pad)
    sentinel = go[0] * go[1] * go[2]
    dev = coords.device
    s = torch.tensor(stride, device=dev)
    cand = []
    for t in taps(kernel):
        num = coords + torch.tensor(pad, device=dev) - torch.tensor(t,
                                                                    device=dev)
        even = (torch.remainder(num, s) == 0).all(1)
        o = torch.div(num, s, rounding_mode="floor")
        lin = _lin(o[:, 0], o[:, 1], o[:, 2], go)
        cand.append(torch.where(even, lin, sentinel))
    lin = torch.unique(torch.cat(cand))
    lin = lin[lin < sentinel][:budget]
    out = torch.stack([lin // (go[1] * go[2]), (lin // go[2]) % go[1],
                       lin % go[2]], 1)
    return out, go


def rulebook(coords_in: torch.Tensor, grid_in, coords_out: torch.Tensor,
             kernel, stride, pad) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Gather-form rulebook: per tap, (output rows, input rows) of the
    pairs that find an input at ``out * stride - pad + tap``."""
    lin_in = _lin(coords_in[:, 0], coords_in[:, 1], coords_in[:, 2],
                  grid_in)
    sentinel = grid_in[0] * grid_in[1] * grid_in[2]
    dev = coords_in.device
    pairs = []
    for t in taps(kernel):
        tap = (coords_out * torch.tensor(stride, device=dev)
               - torch.tensor(pad, device=dev) + torch.tensor(t, device=dev))
        q = _lin(tap[:, 0], tap[:, 1], tap[:, 2], grid_in)
        pos = torch.searchsorted(lin_in, q).clamp(max=max(len(lin_in) - 1,
                                                          0))
        hit = (lin_in[pos] == q) & (q < sentinel) if len(lin_in) else \
            torch.zeros_like(q, dtype=torch.bool)
        rows = torch.nonzero(hit)[:, 0]
        pairs.append((rows, pos[rows]))
    return pairs


def sparse_conv(x: torch.Tensor, rb, n_out: int, kern: torch.Tensor,
                lowp: Cast) -> Tuple[torch.Tensor, int]:
    """y[o] = sum over taps k of x[in_k(o)] @ W_k; (y, pairs)."""
    y = torch.zeros((n_out, kern.shape[2]), device=x.device)
    xl = lowp(x)
    n = 0
    for k, (rows, src) in enumerate(rb):
        n += int(rows.numel())
        y.index_add_(0, rows, xl[src] @ lowp(kern[k]))
    return y, n


def encoder(p: torch.Tensor, w: Dict, cfg: Dict, lowp: Cast = _same,
            work: List = None, calibrate: bool = False) -> torch.Tensor:
    """One cloud's valid points -> its BEV map (C * D, H, W). ``work``
    collects each sparse conv's (rows in, rows out, pairs, C in, C out,
    list size in, list size out, taps); ``calibrate`` sets each
    BatchNorm's running statistics to its input's as it goes."""
    prm = cfg["model"]["params"]
    budgets = [int(b) for b in prm["level_budgets"]]
    coords, x = voxelize_mean(p, cfg)
    grid = sparse_shape(cfg)
    pad_in = int(cfg["budget"]["max_voxels"])
    i = 0

    def conv(x, rb, n_out, pad_out, n_in, k, relu=True):
        nonlocal i
        name = f"encoder/sparse/{i}"
        kern = w[f"params/{name}/kernel"]
        y, pairs = sparse_conv(x, rb, n_out, kern, lowp)
        if work is not None:
            work.append((n_in, n_out, pairs, kern.shape[1], kern.shape[2],
                         pad_in, pad_out, k))
        bias = w.get(f"params/{name}/conv_bias")
        if bias is not None:
            y = y + bias
        y = _bn(y, w, name, 1, calibrate)
        i += 1
        return torch.relu(y) if relu else y

    def strided(x, coords, grid, geo, budget):
        nonlocal pad_in
        out, go = output_set(coords, grid, *geo, budget)
        rb = rulebook(coords, grid, out, *geo)
        # The program's list: the budget, or fewer rows where fewer
        # candidates can be (an input reaches ceil(k / s) outputs an axis).
        reach = 1
        for k, s in zip(geo[0], geo[1]):
            reach *= -(-k // s)
        pad_out = min(budget, pad_in * reach)
        y = conv(x, rb, len(out), pad_out, len(coords), len(rb))
        pad_in = pad_out
        return y, out, go

    for level in range(len(DOWN) + 1):
        if level:
            x, coords, grid = strided(x, coords, grid, DOWN[level - 1],
                                      budgets[level])
        rb = rulebook(coords, grid, coords, *SUBM)
        n = len(coords)
        if not level:
            x = conv(x, rb, n, pad_in, n, 27)
        for _ in range(2):
            h = conv(x, rb, n, pad_in, n, 27)
            x = torch.relu(conv(h, rb, n, pad_in, n, 27, relu=False) + x)
    x, coords, grid = strided(x, coords, grid, CONV_OUT, budgets[-1])

    nz, ny, nx = grid
    c = x.shape[1]
    dense = torch.zeros((c, nz * ny * nx), device=p.device)
    dense[:, _lin(coords[:, 0], coords[:, 1], coords[:, 2], grid)] = x.T
    return dense.view(c * nz, ny, nx)


def _conv_bn_relu(x, w, name, lowp, calibrate):
    """3x3 conv (padding 1) with its bias, BatchNorm, ReLU."""
    k = w[f"params/{name}/kernel"]
    y = F.conv2d(lowp(x), lowp(k.permute(3, 2, 0, 1)), padding=1) \
        + w[f"params/{name}/conv_bias"].view(1, -1, 1, 1)
    return torch.relu(_bn(y, w, name, 1, calibrate))


def head(x: torch.Tensor, w: Dict, tasks: Sequence[Sequence[str]],
         lowp: Cast = _same, calibrate: bool = False
         ) -> Dict[str, torch.Tensor]:
    """(B, C, H, W) -> per head (B, T, c, H, W); ``hm`` has the largest
    class count, a smaller task's extra channels at -inf."""
    x = _conv_bn_relu(x, w, "head/shared", lowp, calibrate)
    width = max(len(t) for t in tasks)
    out = {name: [] for name, _ in HEADS}
    for t, names in enumerate(tasks):
        for name, _ in HEADS:
            base = f"head/tasks/{t}/{name}"
            h = _conv_bn_relu(x, w, f"{base}/conv", lowp, calibrate)
            k = w[f"params/{base}/out/kernel"]
            y = F.conv2d(lowp(h), lowp(k.permute(3, 2, 0, 1)), padding=1) \
                + w[f"params/{base}/out/bias"].view(1, -1, 1, 1)
            if name == "hm" and y.shape[1] < width:
                y = torch.cat([y, torch.full_like(
                    y[:, :1], float("-inf")).expand(
                        -1, width - y.shape[1], -1, -1)], 1)
            out[name].append(y)
    return {k: torch.stack(v, 1) for k, v in out.items()}


def forward(points: torch.Tensor, counts: torch.Tensor, w: Dict,
            cfg: Dict, lowp: Cast = _same, calibrate: bool = False
            ) -> Dict[str, torch.Tensor]:
    """The head's maps of a batch of clouds; with ``calibrate`` (one
    cloud) every BatchNorm's running statistics are set to its input's
    on the way."""
    prm = cfg["model"]["params"]
    bev = torch.stack([encoder(points[i, :int(counts[i])], w, cfg, lowp,
                               calibrate=calibrate)
                       for i in range(points.shape[0])])
    x = backbone(bev, w, prm.get("bev_layers", [5, 5]),
                 prm.get("bev_strides", [1, 2]),
                 prm.get("bev_up_strides", [1, 2]), lowp,
                 calibrate=calibrate)
    return head(x, w, prm["tasks"], lowp, calibrate)


def output_stride(cfg: Dict) -> int:
    return OUTPUT_STRIDE


def decode(maps: Dict[str, torch.Tensor], cfg: Dict, cells: bool = False):
    """One cloud's maps (T, c, H, W) by head -> per task the decoded top
    candidates: (boxes (T, K, 9), scores (T, K) with -inf outside
    ``post_center_range``, class labels (T, K)); with ``cells`` every
    class's every cell instead, K = classes * H * W (no range mask)."""
    prm = cfg["model"]["params"]
    r = cfg["voxel"]["point_cloud_range"]
    vs = cfg["voxel"]["voxel_size"]
    names = cfg["data"]["class_names"]
    tasks = prm["tasks"]
    hm = torch.sigmoid(maps["hm"])
    t, c, h, wd = hm.shape
    flat = hm.reshape(t, c * h * wd)
    if cells:
        idx = torch.arange(c * h * wd, device=hm.device).expand(t, -1)
        scores = flat
    else:
        k = min(int(prm.get("max_obj_per_sample", 500)),
                int(prm.get("nms_pre", 1000)), c * h * wd)
        order = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, idx = order.values[:, :k], order.indices[:, :k]
    cls = idx // (h * wd)
    cell = idx % (h * wd)

    def at(name):
        m = maps[name].reshape(t, maps[name].shape[1], h * wd)
        return torch.gather(m, 2, cell[:, None, :].expand(
            -1, m.shape[1], -1)).permute(0, 2, 1)
    ctr = at("center")
    x = ((cell % wd).float() + ctr[..., 0]) * OUTPUT_STRIDE * vs[0] + r[0]
    y = ((cell // wd).float() + ctr[..., 1]) * OUTPUT_STRIDE * vs[1] + r[1]
    z = at("center_z")[..., 0]
    rot = at("rot")
    boxes = torch.cat([torch.stack([x, y, z], -1), torch.exp(at("dim")),
                       torch.atan2(rot[..., 1], rot[..., 0])[..., None],
                       at("vel")], -1)
    table = torch.tensor([[names.index(n) for n in task]
                          + [-1] * (c - len(task)) for task in tasks],
                         device=hm.device)
    labels = torch.gather(table, 1, cls)
    if not cells:
        rng = prm.get("post_center_range",
                      [r[0], r[1], -10.0, r[3], r[4], 10.0])
        inside = ((boxes[..., :3] >= torch.tensor(rng[:3], device=hm.device))
                  & (boxes[..., :3] <= torch.tensor(rng[3:],
                                                    device=hm.device))
                  ).all(-1)
        scores = torch.where(inside, scores, float("-inf"))
    return boxes, scores, labels


def nms_task(boxes: torch.Tensor, scores: torch.Tensor,
             labels: torch.Tensor, cfg: Dict) -> Dict[str, torch.Tensor]:
    """One task's greedy NMS over its candidates, whatever their class:
    the kept boxes (9 columns), scores and class labels."""
    prm = cfg["model"]["params"]
    # The label rides in a tenth box column through the class-blind NMS.
    rows = torch.cat([boxes, labels[:, None].float()], 1)
    kept = detect.greedy_nms(
        rows, scores, torch.zeros_like(labels),
        iou_thr=float(prm.get("nms_iou", 0.2)),
        score_thr=float(prm.get("score_threshold", 0.1)),
        pre=len(scores), post=int(prm.get("nms_post", 83)),
        near=int(cfg["budget"].get("nms_near", 0)))
    return {"boxes": kept["boxes"][:, :9], "scores": kept["scores"],
            "labels": kept["boxes"][:, 9].round().long()}


@torch.no_grad()
def detections(points: torch.Tensor, counts: torch.Tensor, w: Dict,
               cfg: Dict, lowp: Cast = None) -> List[Dict]:
    """Per cloud of (B, N, 5) ``points``: ``all`` (every class's every
    cell decoded: boxes (A, 9), scores, labels), ``cand`` (each task's
    candidates that NMS took: boxes, scores, labels, ``task``) and
    ``dets`` (the kept detections of every task by descending score:
    boxes, scores, labels, ``task``)."""
    with exact_float32():
        maps = forward(points, counts, w, cfg, lowp or _same)
    result = []
    for i in range(points.shape[0]):
        one = {k: v[i] for k, v in maps.items()}
        ab, as_, al = decode(one, cfg, cells=True)
        keep = al >= 0
        cb, cs, cl = decode(one, cfg)
        t, k = cs.shape
        task = torch.arange(t, device=cs.device)[:, None].expand(-1, k)
        kept = [nms_task(cb[j], cs[j], cl[j], cfg) for j in range(t)]
        dets = {key: torch.cat([d[key] for d in kept])
                for key in ("boxes", "scores", "labels")}
        dets["task"] = torch.cat([torch.full_like(d["labels"], j)
                                  for j, d in enumerate(kept)])
        order = torch.sort(dets["scores"], descending=True,
                           stable=True).indices
        result.append({
            "all": {"boxes": ab[keep], "scores": as_[keep],
                    "labels": al[keep]},
            "cand": {"boxes": cb.reshape(-1, 9), "scores": cs.reshape(-1),
                     "labels": cl.reshape(-1), "task": task.reshape(-1)},
            "dets": {key: v[order] for key, v in dets.items()}})
    return result


def as_served(dets: Dict[str, torch.Tensor], post: int) -> Dict:
    """Detections in the served layout: ``post`` rows, ``valid`` first."""
    n = dets["scores"].shape[0]
    boxes = torch.zeros((post, 9))
    boxes[:n] = dets["boxes"].cpu()
    scores = torch.zeros((post,))
    scores[:n] = dets["scores"].cpu()
    labels = torch.full((post,), -1, dtype=torch.int32)
    labels[:n] = dets["labels"].cpu().int()
    valid = torch.arange(post) < n
    return {"boxes": boxes.numpy(), "scores": scores.numpy(),
            "labels": labels.numpy(), "valid": valid.numpy()}


def layer_work(points: torch.Tensor, counts: torch.Tensor, w: Dict,
               cfg: Dict) -> List[List[Tuple]]:
    """Each cloud's sparse convs: (rows in, rows out, pairs, C in, C out,
    list size in, list size out, taps)."""
    out = []
    for i in range(points.shape[0]):
        work: List = []
        encoder(points[i, :int(counts[i])], w, cfg, work=work)
        out.append(work)
    return out


def level_counts(points: torch.Tensor, counts: torch.Tensor, cfg: Dict
                 ) -> List[List[int]]:
    """Each cloud's list sizes before any budget cut: voxels, then the
    output set of each strided conv (levels 1-3, ``conv_out``)."""
    out = []
    for i in range(points.shape[0]):
        coords, _ = voxelize_mean(points[i, :int(counts[i])], cfg)
        grid = sparse_shape(cfg)
        row = [len(coords)]
        for geo in DOWN + (CONV_OUT,):
            coords, grid = output_set(coords, grid, *geo, 1 << 62)
            row.append(len(coords))
        out.append(row)
    return out

