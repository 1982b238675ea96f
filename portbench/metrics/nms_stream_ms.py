"""Rotated NMS (``ops/nms.py::rotated_nms``, whole), the program's span
``nms``, stream ms a request (``infer`` span)."""

from portbench.harness import spans

LAYER = "post-processing"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("nms",), spans.stream_ms)
