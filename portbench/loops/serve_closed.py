"""The serving loop: a closed loop of one client that sends a batch of
scenes, waits for the detections on the host, and sends the next.

A request runs from the call, which packs the batch onto the int16 wire
(``pack_points_q16`` on the host), through ``infer_packed`` to the
boxes, scores, labels and ``valid`` on the host. The scenes are a pool
made from the seed; ``distinct_batches`` batches of ``batch`` scenes are
drawn from the pool once, and the requests send each of them once a
round, in an order drawn from the seed.

Mix parameters (``portbench/traffic/<mix>.json``): ``scenes`` (the scene
generator, ``portbench/traffic/<scenes>.py``), ``batch``, ``pool``,
``distinct_batches``, ``warmup_requests``, ``trace_skip`` and
``trace_requests`` (the traced window), ``probe_calls`` (device-resident
calls of each distinct batch timed with CUDA events after a traced
window), ``check_requests`` (requests the reference checks after the
window), ``reference_block`` (clouds the reference runs at once).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import reference
from portbench.harness import trace as tracing
from portbench.harness import weights as wmod
from portbench.harness.pool import make_pool
from portbench.harness.spec import Cell
from portbench.reference import compare, faults, lowp, wire

OUTPUT_KEYS = ("boxes", "scores", "labels", "valid")


class Timer:
    """Seconds a call takes on the device: CUDA events around ``n`` calls
    on a card, the host clock around them elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mean_s(self, fn, n: int) -> float:
        fn()
        if self.cuda:
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) * 1e-3 / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n


class Loop:
    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.mix = cell.traffic
        self.cfg = cell.program_config
        self.model = cell.reference
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 0x5E7]))
        self.latency: List[float] = []
        self.batch_of: List[int] = []
        self.outputs: List[Dict[str, np.ndarray]] = []
        self.traced: List[int] = []
        self.summary: Dict = {}
        self.spans: Dict[str, float] = {}
        self.picks = None
        self.stages: Dict[str, float] = {}

    # -- set-up --------------------------------------------------------------

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
        # Each round of ``distinct_batches`` requests sends every batch
        # once, in an order drawn from the seed.
        d = len(self.batches)
        self.order = np.concatenate([self.rng.permutation(d)
                                     for _ in range((1 << 16) // d)])
        t = time.perf_counter()
        for i in range(int(mix["warmup_requests"])):
            self._request(i, keep=False)
        self.stages["warmup_s"] = time.perf_counter() - t

    def _load_weights(self) -> None:
        spec = self.cell.config["weights"]
        model = self.pipeline.model
        if spec["kind"] == "snapshot":
            from lisec_tpu_torch.weights import load_weights_npz
            flat = wmod.snapshot(spec, self.cell.root)
            load_weights_npz(model, str(self.cell.root / spec["file"]))
            self.weights = {k: torch.as_tensor(v, device=self.device)
                            for k, v in flat.items()}
        else:
            from lisec_tpu_torch.weights import (
                convert_flax_arrays, to_flax_arrays)
            layout = {k: tuple(v.shape)
                      for k, v in to_flax_arrays(model).items()}
            # The configuration fixes the draw, as a snapshot would: its
            # own seed, and calibration scenes made from that seed.
            wseed = int(spec["weight_seed"])
            self.weights = wmod.seed_draw(layout, spec, wseed, self.device)
            if spec.get("calibrate_clouds"):
                pts, counts = make_pool(
                    self.cfg, spec["calibrate_scenes"],
                    spec["calibrate_clouds"], wseed, self.cell.root)
                wmod.calibrate(self.weights, spec,
                               torch.as_tensor(pts, device=self.device),
                               torch.as_tensor(counts), self.cfg,
                               self.model)
            host = {k: v.cpu().numpy() for k, v in self.weights.items()}
            model.load_state_dict(convert_flax_arrays(
                host, getattr(model, "FLAX_KEYS", None)), strict=True)
        model.eval()

    # -- the window ----------------------------------------------------------

    def _request(self, r: int, keep: bool = True) -> None:
        from lisec_tpu_torch.data.wire import pack_points_q16
        bid = int(self.order[r % len(self.order)])
        _, pts, mask = self.batches[bid]
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.request"):
            packed = pack_points_q16(pts, mask)
            out = self.pipeline.infer_packed(packed)
            host = {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}
        dt = time.perf_counter() - t0
        if keep:
            self.latency.append(dt)
            self.batch_of.append(bid)
            self.outputs.append(host)

    def window(self, seconds: float, traced: bool) -> None:
        mix = self.mix
        t0 = time.perf_counter()
        end = t0 + seconds
        r = int(mix["warmup_requests"])
        if traced:
            for _ in range(int(mix["trace_skip"])):
                self._request(r)
                r += 1
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                for _ in range(int(mix["trace_requests"])):
                    self.traced.append(len(self.latency))
                    self._request(r)
                    r += 1
            self.summary = tracing.summarize(tracing.export_events(prof))
        while time.perf_counter() < end:
            self._request(r)
            r += 1
        self.window_s = time.perf_counter() - t0
        if traced:
            self._probe()

    def _probe(self) -> None:
        """Device-resident calls of each distinct batch that the window's
        unprofiled requests sent: the model's forward alone (with what
        the pipeline prepares for it from the points: SECOND's
        voxelizer) and the whole predict, CUDA events around
        ``probe_calls`` calls of each; each batch weighs as often as
        those requests sent it."""
        from lisec_tpu_torch.data.wire import (
            pack_points_q16, unpack_points_q16)
        skip = set(self.traced)
        sent = np.bincount([b for i, b in enumerate(self.batch_of)
                            if i not in skip],
                           minlength=len(self.batches))
        pipe, n = self.pipeline, int(self.mix["probe_calls"])
        timer = Timer(self.device)
        fwd = pred = 0.0
        with torch.no_grad():
            for bid in np.flatnonzero(sent):
                _, pts, mask = self.batches[bid]
                staged = unpack_points_q16(
                    {k: torch.as_tensor(v, device=self.device)
                     for k, v in pack_points_q16(pts, mask).items()})
                fwd += sent[bid] * timer.mean_s(
                    lambda: pipe.model(*pipe._model_args(staged)), n)
                pred += sent[bid] * timer.mean_s(
                    lambda: pipe.predict(staged), n)
        if sent.sum():
            self.spans["forward_s"] = fwd / sent.sum()
            self.spans["predict_s"] = pred / sent.sum()

    # -- results -------------------------------------------------------------

    def end_to_end(self) -> Dict[str, float]:
        b = int(self.mix["batch"])
        return {"clouds_per_s": b * len(self.latency) / self.window_s,
                "latency_p95_ms": float(np.percentile(self.latency, 95))
                * 1e3}

    @property
    def attempted(self) -> int:
        return len(self.latency)

    def describe(self) -> str:
        """One line on the window's requests, for standard error."""
        lat = np.asarray(self.latency) * 1e3
        by = np.asarray(self.batch_of)
        return (f"requests: {len(lat)} in {self.window_s:.3f} s; latency "
                f"ms min {lat.min():.2f} median {np.median(lat):.2f} p95 "
                f"{np.percentile(lat, 95):.2f} max {lat.max():.2f}; by "
                "batch " + ", ".join(f"{b}: {lat[by == b].mean():.2f}"
                                     for b in sorted(set(self.batch_of))))

    def context(self) -> Dict:
        """What the per-layer readers read."""
        cfg, mix = self.cfg, self.mix
        b = int(mix["batch"])
        traced_batches = [self.batch_of[i] for i in self.traced]
        skip = set(self.traced)
        untraced = [t for i, t in enumerate(self.latency) if i not in skip]
        counters = {"clouds_traced": b * len(self.traced),
                    "model_flops_traced": 0.0}
        per_batch = {}
        for bid in set(traced_batches):
            _, pts, mask = self.batches[bid]
            per_batch[bid] = self.cell.counters.count(
                cfg, pts, mask.sum(1), self.weights, self.device)
        for bid in traced_batches:
            flops, bounds = per_batch[bid]
            counters["model_flops_traced"] += flops
            for k, v in bounds.items():
                counters[k] = counters.get(k, 0.0) + v
        return {"cell": self.cell.name, "config": cfg, "mix": mix,
                "trace": self.summary,
                "spans": dict(self.spans,
                              request_s=float(np.mean(untraced))
                              if untraced else None),
                "counters": counters}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.pipeline
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, stand_in: str = "",
              detail: bool = False) -> Dict[str, float]:
        """The reference over a sample of the window's requests, drawn
        from the seed. With ``stand_in``, the reference is put in the
        program's place: ``control``, computed in the next lower
        precision (``reference/lowp.py``), or a fault of
        ``reference/faults.py`` planted in it."""
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
        post = int(self.cfg["budget"]["nms_post"])
        served, refs = [], []
        for r in self.picks:
            rows, pts, mask = self.batches[self.batch_of[r]]
            counts = mask.sum(1)
            q, lo, scale = wire.pack_q16(pts, counts)
            points = wire.dequantize(q, lo, scale, self.device)
            counts_t = torch.as_tensor(counts)
            for i in range(0, len(rows), block):
                args = (self.model, points[i:i + block],
                        counts_t[i:i + block], self.weights)
                refs += reference.detections(*args, self.cfg)
                if stand_in:
                    served += [reference.as_served(c["dets"], post)
                               for c in reference.detections(
                                   *args, cfg_in, cast)]
            if not stand_in:
                out = self.outputs[r]
                served += [{k: out[k][j] for k in OUTPUT_KEYS}
                           for j in range(len(rows))]
        return compare.compare(served, refs, self.cfg, detail)

    def malformed(self) -> int:
        """Requests whose outputs are not finite or of the wrong shape."""
        post = int(self.cfg["budget"]["nms_post"])
        b = int(self.mix["batch"])
        bad = 0
        for out in self.outputs:
            ok = (out["boxes"].shape == (b, post, 7)
                  and out["valid"].shape == (b, post)
                  and np.isfinite(out["boxes"]).all()
                  and np.isfinite(out["scores"]).all())
            bad += not ok
        return bad
