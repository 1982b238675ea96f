"""Score preselect, gathers, box decode and direction bins inside
``predict``, the program's span ``predict.decode``, stream ms a request
(``infer`` span)."""

from portbench.harness import spans

LAYER = "post-processing"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("predict.decode",), spans.stream_ms)
