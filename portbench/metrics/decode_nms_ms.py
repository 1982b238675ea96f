"""Post-processing: the device-resident ``predict`` less the model's
forward (score preselect, decode, direction bins, rotated NMS), both
taken over the same batches with the same weights
(``forward_ms.serve``), ms a batch."""

LAYER = "post-processing"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    s = ctx["spans"]
    if s.get("predict_s") is None or s.get("forward_s") is None:
        return None
    return 1e3 * (s["predict_s"] - s["forward_s"])
