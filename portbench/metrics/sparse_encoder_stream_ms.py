"""The program's ``encoder`` span: the residual sparse encoder to the
BEV map, its rulebooks and 21 sparse convs inside; stream ms a request
(``infer`` span)."""

from portbench.harness import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("encoder",), spans.stream_ms)
