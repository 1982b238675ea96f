"""The sparse convs' fused kernel (``ops/cuda/spread_conv.py``), the
program's span ``spconv`` around each ``sparse_conv3d_spread`` call on
the card, stream ms a request (``infer`` span), summed over the calls.
It reads only where the span is recorded."""

from portbench.harness import spans

LAYER = "kernels"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("spconv",), spans.stream_ms)
