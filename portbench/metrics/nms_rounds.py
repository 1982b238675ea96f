"""Rounds of the NMS loop a request (``infer`` span): the program's
``nms.round`` spans, each one host wait for the card."""

from portbench.harness import spans

LAYER = "post-processing"
UNIT = "rounds"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("nms.round",), spans.count)
