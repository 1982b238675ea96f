"""SECOND's rulebook builds (each level's submanifold rulebook and its
inverse, each downsample's output set and rulebook), the program's
``rulebook`` spans, stream ms summed a request (``infer`` span)."""

from portbench.harness import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("rulebook",), spans.stream_ms)
