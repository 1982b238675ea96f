"""The NMS rounds' kernel (``ops/cuda/rotated_nms.py``), the program's
span ``nms.kernel`` around its one launch, stream ms a request
(``infer`` span). It reads only where the kernel ran."""

from portbench.harness import spans

LAYER = "post-processing"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("nms.kernel",), spans.stream_ms)
