"""The model's forward alone (``pipeline.model(points, mask)``) on each
distinct batch that the window's unprofiled requests sent, staged on the
card, CUDA events around ``probe_calls`` calls of each, weighted by how
often those requests sent it; ms a call."""

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    s = ctx["spans"].get("forward_s")
    return None if s is None else 1e3 * s
