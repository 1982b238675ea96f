"""The program's ``center.head`` span: the centre head, its shared conv
and the six tasks' 36 first and 36 output convs; stream ms a request
(``infer`` span)."""

from portbench.harness import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("center.head",), spans.stream_ms)
