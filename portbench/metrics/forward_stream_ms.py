"""The model's forward inside ``predict`` (with SECOND's voxelizer), the
program's span ``predict.forward``, stream ms a request (``infer``
span)."""

from portbench.harness import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("predict.forward",), spans.stream_ms)
