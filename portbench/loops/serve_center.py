"""The serving loop of a centre-based detector (CenterPoint): the closed
loop of ``serve_closed.py`` over multi-channel frames, whose detections
are 9-dim boxes (x, y, z, l, w, h, yaw, vx, vy) kept per task.

What differs from ``serve_closed.Loop``:

* the scene pool holds the configuration's ``in_channels`` channels
  (x, y, z, intensity, time lag);
* seed weights: every kernel drawn as ``harness/weights.py::seed_draw``
  draws it (N(0, gain / fan_in)), then each head's output conv scaled to
  its ``head_gains`` entry and its bias set from the classes' size
  priors (``dim``: the log of the task's mean size; ``center_z``: the
  ground plus half its height; ``center``: 0.5, the cell's middle), the
  BatchNorms calibrated in the reference on ``calibrate_clouds`` scenes
  (``harness/weights.py``'s rule), and one heatmap bias for every task
  set so that ``positive_share`` of the heatmap cells score above the
  threshold;
* ``check`` runs ``reference/centerpoint.py`` and compares
  (``compare_center``): ``det_gap_mean``, the mean over served
  detections of the smallest gap to a reference detection of the same
  class at any cell (``compare.py``'s gap, with the heading compared
  over a whole turn, since ``atan2`` leaves no half to choose, and the
  velocity in m/s added); ``missed``, ``missed_mean`` and
  ``extra_share`` as ``compare.py`` reads them, with the tasks in place
  of the classes, since NMS suppresses within a task whatever the class;
* ``malformed`` holds each output to (B, tasks x ``nms_post``, 9).
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import reference
from portbench.harness import weights as wmod
from portbench.harness.spec import load_module
from portbench.loops import serve_closed
from portbench.reference import compare, faults, lowp, wire

OUTPUT_KEYS = serve_closed.OUTPUT_KEYS
HEAD_OUT = "params/head/tasks/{t}/{head}/out/{leaf}"


def make_pool(cfg: Dict, scenes: str, pool: int, seed: int, root: Path):
    """``harness/pool.py::make_pool`` for frames of the configuration's
    ``in_channels``: (points (P, N, C) f32, counts (P,))."""
    n = int(cfg["budget"]["max_points"])
    c = int(cfg["model"]["params"].get("in_channels", 5))
    seeds = np.random.SeedSequence(int(seed)).generate_state(int(pool))
    make = load_module("traffic", scenes, root).make_scene
    pts = np.zeros((len(seeds), n, c), np.float32)
    counts = np.zeros((len(seeds),), np.int64)
    r = tuple(cfg["voxel"]["point_cloud_range"])
    for i, s in enumerate(seeds):
        p = make(int(s), pc_range=r)["points"][:n]
        pts[i, :len(p)] = p
        counts[i] = len(p)
    return pts, counts


def draw_weights(layout: Dict, spec: Dict, cfg: Dict, device
                 ) -> Dict[str, torch.Tensor]:
    """The seed draw before calibration (see the module's note)."""
    w = wmod.seed_draw(layout, spec, int(spec["weight_seed"]), device)
    prm = cfg["model"]["params"]
    gain = float(spec["gain"])
    priors = spec["size_priors"]
    ground = float(spec["ground_z"])
    for t, names in enumerate(prm["tasks"]):
        size = np.mean([priors[n] for n in names], axis=0)
        for head, g in spec["head_gains"].items():
            w[HEAD_OUT.format(t=t, head=head, leaf="kernel")] *= \
                math.sqrt(float(g) / gain)
        bias = {"center": [0.5, 0.5], "center_z": [ground + size[2] / 2],
                "dim": np.log(size).tolist()}
        for head, v in bias.items():
            w[HEAD_OUT.format(t=t, head=head, leaf="bias")].copy_(
                torch.tensor(v, dtype=torch.float32))
    return w


def calibrate(w: Dict[str, torch.Tensor], spec: Dict, points: torch.Tensor,
              counts: torch.Tensor, cfg: Dict, model) -> None:
    """Running statistics of every BatchNorm, then the heatmap biases, in
    place, from the reference ``model`` over ``points``."""
    n = int(spec["calibrate_clouds"])
    tasks = cfg["model"]["params"]["tasks"]
    keys = [HEAD_OUT.format(t=t, head="hm", leaf="bias")
            for t in range(len(tasks))]
    with torch.no_grad(), reference.exact_float32():
        for i in range(n):
            model.forward(points[i:i + 1], counts[i:i + 1], w, cfg,
                          calibrate=True)
        for k in keys:
            w[k].zero_()
        logits = torch.cat([
            model.forward(points[i:i + 1], counts[i:i + 1], w, cfg)["hm"]
            .flatten() for i in range(n)])
    logits = logits[torch.isfinite(logits)]
    thr = float(cfg["model"]["params"].get("score_threshold", 0.1))
    top = torch.quantile(logits.float(), 1.0 - float(spec["positive_share"]))
    for k in keys:
        w[k].fill_(math.log(thr / (1.0 - thr)) - float(top))


def _gaps(box: torch.Tensor, score: torch.Tensor, ref: Dict
          ) -> torch.Tensor:
    """For served boxes (P, 9) and scores (P,): the smallest gap to the
    reference's rows ``ref`` (boxes, scores): the largest of the centre
    (m), log size, heading (over a whole turn), velocity (m/s) and score
    differences."""
    out = []
    rb, rs = ref["boxes"], ref["scores"]
    for i in range(0, box.shape[0], 16):
        b = box[i:i + 16, None, :]
        dy = torch.remainder(b[..., 6] - rb[None, :, 6] + math.pi,
                             2 * math.pi) - math.pi
        g = torch.stack([
            (b[..., :3] - rb[None, :, :3]).abs().amax(-1),
            (b[..., 3:6].log() - rb[None, :, 3:6].log()).abs().amax(-1),
            dy.abs(), (b[..., 7:9] - rb[None, :, 7:9]).abs().amax(-1),
            (score[i:i + 16, None] - rs[None, :]).abs()]).amax(0)
        out.append(g.min(1).values)
    return torch.cat(out) if out else box.new_zeros((0,))


def compare_center(served: List[Dict[str, np.ndarray]], refs: List[Dict],
                   cfg: Dict) -> Dict:
    """``det_gap_mean``, ``missed``, ``missed_mean`` and ``extra_share``
    of the served detections against the reference's (see the module's
    note), with the counts."""
    prm = cfg["model"]["params"]
    names = cfg["data"]["class_names"]
    task_of = torch.zeros(len(names), dtype=torch.long)
    for t, task in enumerate(prm["tasks"]):
        for n in task:
            task_of[names.index(n)] = t
    n_tasks = len(prm["tasks"])
    k = min(int(prm.get("max_obj_per_sample", 500)),
            int(prm.get("nms_pre", 1000)))
    # compare.py's view: the tasks as classes, each task's candidates as
    # the anchors its NMS had.
    by_task = {"model": {"params": {
        "score_threshold": prm.get("score_threshold", 0.1),
        "nms_iou": prm.get("nms_iou", 0.2)}},
        "budget": {"nms_post": n_tasks * int(prm.get("nms_post", 83)),
                   "nms_pre": n_tasks * k,
                   "nms_near": int(cfg["budget"].get("nms_near", 0))}}
    gaps, shorts = [], []
    n_served = n_extra = n_ref = 0
    missed = 0.0
    for s, r in zip(served, refs):
        dev = r["all"]["boxes"].device
        valid = np.asarray(s["valid"], bool)
        box = torch.as_tensor(np.asarray(s["boxes"])[valid],
                              dtype=torch.float32, device=dev)
        score = torch.as_tensor(np.asarray(s["scores"])[valid],
                                dtype=torch.float32, device=dev)
        label = torch.as_tensor(np.asarray(s["labels"])[valid],
                                dtype=torch.long, device=dev)
        allr = r["all"]
        for c in torch.unique(label).tolist():
            sel = label == c
            on = allr["labels"] == c
            gaps.append(_gaps(box[sel], score[sel],
                              {"boxes": allr["boxes"][on],
                               "scores": allr["scores"][on]}).cpu())
        cand, dets = r["cand"], r["dets"]
        as_task = {
            "all": {"boxes": cand["boxes"], "scores": cand["scores"],
                    "labels": cand["task"],
                    "edge": torch.zeros_like(cand["task"], dtype=torch.bool),
                    "dir_margin": torch.full_like(cand["scores"], math.inf)},
            "dets": {"boxes": dets["boxes"], "scores": dets["scores"],
                     "labels": dets["task"]}}
        one = compare.compare_cloud(
            {"boxes": np.asarray(s["boxes"]), "scores": np.asarray(s["scores"]),
             "labels": task_of[torch.as_tensor(
                 np.asarray(s["labels"]), dtype=torch.long).clamp(min=0)
             ].numpy(),
             "valid": valid}, as_task, by_task)
        missed = max(missed, one["missed"])
        shorts.append(one["shorts"])
        n_extra += one["extra"]
        n_served += int(valid.sum())
        n_ref += int(dets["scores"].numel())
    g = torch.cat(gaps).double() if gaps else torch.zeros(0)
    m = torch.cat(shorts) if shorts else torch.zeros(0)
    return {"det_gap_mean": float(g.mean()) if g.numel() else 0.0,
            "det_gap": float(g.max()) if g.numel() else 0.0,
            "missed": missed,
            "missed_mean": float(m.mean()) if m.numel() else 0.0,
            "extra_share": n_extra / max(n_served, 1),
            "clouds": len(served), "served_detections": n_served,
            "extra_detections": n_extra, "reference_detections": n_ref}


class Loop(serve_closed.Loop):
    def setup(self) -> None:
        from lisec_tpu_torch.api import build_model
        from lisec_tpu_torch.config import config_from_dict
        t = time.perf_counter()
        self.pipeline = build_model(config_from_dict(self.cfg),
                                    device=self.device)
        self.stages["build_model_s"] = time.perf_counter() - t
        mix = self.mix
        t = time.perf_counter()
        self.pool, self.counts = make_pool(self.cfg, mix["scenes"],
                                           mix["pool"], self.seed,
                                           self.cell.root)
        self.stages["scenes_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._load_weights()
        self.stages["weights_s"] = time.perf_counter() - t
        b = int(mix["batch"])
        n = self.pool.shape[1]
        self.batches = []
        for _ in range(int(mix["distinct_batches"])):
            rows = self.rng.choice(len(self.pool), b, replace=False)
            mask = np.arange(n)[None, :] < self.counts[rows][:, None]
            self.batches.append((rows, np.ascontiguousarray(self.pool[rows]),
                                 mask))
        d = len(self.batches)
        self.order = np.concatenate([self.rng.permutation(d)
                                     for _ in range((1 << 16) // d)])
        t = time.perf_counter()
        for i in range(int(mix["warmup_requests"])):
            self._request(i, keep=False)
        self.stages["warmup_s"] = time.perf_counter() - t

    def _load_weights(self) -> None:
        from lisec_tpu_torch.weights import (
            convert_flax_arrays, to_flax_arrays)
        spec = self.cell.config["weights"]
        model = self.pipeline.model
        layout = {k: tuple(v.shape)
                  for k, v in to_flax_arrays(model).items()}
        self.weights = draw_weights(layout, spec, self.cfg, self.device)
        wseed = int(spec["weight_seed"])
        pts, counts = make_pool(self.cfg, spec["calibrate_scenes"],
                                spec["calibrate_clouds"], wseed,
                                self.cell.root)
        calibrate(self.weights, spec, torch.as_tensor(pts, device=self.device),
                  torch.as_tensor(counts), self.cfg, self.model)
        host = {k: v.cpu().numpy() for k, v in self.weights.items()}
        model.load_state_dict(convert_flax_arrays(
            host, getattr(model, "FLAX_KEYS", None)), strict=True)
        model.eval()

    def _post(self) -> int:
        prm = self.cfg["model"]["params"]
        return len(prm["tasks"]) * int(prm.get("nms_post", 83))

    def check(self, stand_in: str = "",
              detail: bool = False) -> Dict[str, float]:
        """The reference over a sample of the window's requests, drawn
        from the seed; with ``stand_in`` the control or a planted fault
        in the program's place (``serve_closed.Loop.check``)."""
        if self.picks is None:
            k = min(int(self.mix["check_requests"]), len(self.outputs))
            self.picks = sorted(self.rng.choice(len(self.outputs), k,
                                                replace=False).tolist())
        block = int(self.mix["reference_block"])
        cast, cfg_in = None, self.cfg
        if stand_in == "control":
            cast = lowp.control_cast(self.cfg)
        elif stand_in:
            cfg_in = faults.planted(self.cfg, stand_in)
        post = self._post()
        served, refs = [], []
        for r in self.picks:
            rows, pts, mask = self.batches[self.batch_of[r]]
            counts = mask.sum(1)
            q, lo, scale = wire.pack_q16(pts, counts)
            points = wire.dequantize(q, lo, scale, self.device)
            counts_t = torch.as_tensor(counts)
            for i in range(0, len(rows), block):
                args = (points[i:i + block], counts_t[i:i + block],
                        self.weights)
                refs += self.model.detections(*args, self.cfg)
                if stand_in:
                    served += [self.model.as_served(c["dets"], post)
                               for c in self.model.detections(
                                   *args, cfg_in, cast)]
            if not stand_in:
                out = self.outputs[r]
                served += [{k: out[k][j] for k in OUTPUT_KEYS}
                           for j in range(len(rows))]
        return compare_center(served, refs, self.cfg)

    def malformed(self) -> int:
        """Requests whose outputs are not finite or of the wrong shape."""
        post = self._post()
        b = int(self.mix["batch"])
        bad = 0
        for out in self.outputs:
            ok = (out["boxes"].shape == (b, post, 9)
                  and out["valid"].shape == (b, post)
                  and np.isfinite(out["boxes"]).all()
                  and np.isfinite(out["scores"]).all())
            bad += not ok
        return bad
