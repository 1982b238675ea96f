"""Fixed-shape batching (port of ``lisec_tpu/data/collate.py``, in plain
numpy).

Every sample is padded to the config budgets (max points, max boxes) so
batch shapes are static; overflowing points are dropped deterministically
(lowest indices kept). The batch order is the JAX package's, bit for
bit: it derives from ``(seed, epoch)`` and ``(seed, epoch, batch)``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def pad_points(cloud: np.ndarray, max_points: int) -> Dict[str, np.ndarray]:
    """Pad/truncate one (N, C) cloud to (max_points, C) + bool mask."""
    cloud = np.ascontiguousarray(cloud, np.float32)
    n = min(len(cloud), max_points)
    points = np.zeros((max_points, cloud.shape[1]), np.float32)
    points[:n] = cloud[:n]
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return {"points": points, "point_mask": mask}


def pad_labels(labels: np.ndarray, max_points: int) -> np.ndarray:
    """Pad/truncate per-point labels to (max_points,), padding with the
    ignore label -1."""
    out = np.full((max_points,), -1, labels.dtype)
    n = min(len(labels), max_points)
    out[:n] = labels[:n]
    return out


def pad_boxes(boxes: np.ndarray, classes: np.ndarray,
              max_boxes: int) -> Dict[str, np.ndarray]:
    """Pad/truncate (B, 7) gt boxes + (B,) class ids to the budget."""
    b = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 7), np.float32)
    out_cls = np.full((max_boxes,), -1, np.int32)
    out_boxes[:b] = boxes[:b]
    out_cls[:b] = classes[:b]
    mask = np.zeros((max_boxes,), bool)
    mask[:b] = True
    return {"gt_boxes": out_boxes, "gt_classes": out_cls, "gt_mask": mask}


def pad_to_budget(sample: Dict[str, np.ndarray], budget) -> Dict[str, np.ndarray]:
    """Pad a raw detection or part-segmentation sample dict to the
    BudgetConfig shapes. The per-cloud label of classification comes with
    that workload; a sample that carries it is refused."""
    if "label" in sample:
        raise NotImplementedError(
            "pad_to_budget: 'label' belongs to classification, which is "
            "not ported yet")
    out: Dict[str, np.ndarray] = {}
    out.update(pad_points(sample["points"], budget.max_points))
    if "point_labels" in sample:
        out["point_labels"] = pad_labels(
            sample["point_labels"], budget.max_points)
    if "category" in sample:
        out["category"] = np.asarray(sample["category"], np.int32)
    if "gt_boxes" in sample:
        out.update(pad_boxes(sample["gt_boxes"], sample["gt_classes"],
                             budget.max_boxes))
        if "difficulty" in sample:
            # Keep per-gt difficulty alongside the padded boxes so the
            # KITTI AP evaluator can bucket easy/moderate/hard (-1 fill
            # = "ignore always").
            diff = np.asarray(sample["difficulty"], np.int32)
            b = min(len(diff), budget.max_boxes)
            out["difficulty"] = np.full((budget.max_boxes,), -1, np.int32)
            out["difficulty"][:b] = diff[:b]
    return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack padded samples into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def make_batches(
    dataset,
    budget,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epochs: int | None = None,
    augment_fn=None,
    start_batch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches from an indexable dataset forever (or
    for `epochs` epochs).

    The stream is seekable: shuffle order derives from ``(seed, epoch)``
    and augmentation randomness from ``(seed, epoch, batch)``, so
    ``start_batch=k`` resumes at batch k in O(1) instead of replaying k
    host-side collations.
    """
    if len(dataset) == 0:
        raise ValueError("make_batches: empty dataset")
    n = len(dataset)
    # Tiny (fixture) datasets tile up so one batch always exists rather
    # than silently yielding nothing.
    order_len = n if n >= batch_size else n * (-(-batch_size // n))
    per_epoch = (order_len // batch_size if drop_last
                 else -(-order_len // batch_size))
    epoch = start_batch // per_epoch
    in_epoch = start_batch % per_epoch
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(order)
        if n < batch_size:
            order = np.tile(order, -(-batch_size // n))
        for k in range(in_epoch, per_epoch):
            idx = order[k * batch_size:(k + 1) * batch_size]
            brng = np.random.default_rng((seed, epoch, k))
            samples = []
            for j in idx:
                s = dataset[int(j)]
                if augment_fn is not None:
                    s = augment_fn(s, brng)
                samples.append(pad_to_budget(s, budget))
            yield collate(samples)
        in_epoch = 0
        epoch += 1


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a background thread with a bounded queue so
    host-side collation overlaps device compute. An exception in the
    iterator is raised again in the consumer, at the item it would have
    produced."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put((item, None))
            q.put((sentinel, None))
        except BaseException as exc:            # handed to the consumer
            q.put((sentinel, exc))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item, exc = q.get()
        if exc is not None:
            raise exc
        if item is sentinel:
            return
        yield item
