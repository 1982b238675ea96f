"""API and wire: the copy of a request's wire arrays to the card and
their dequantization there, the program's spans ``wire.h2d`` and
``wire.unpack``, stream ms a request (``infer`` span)."""

from portbench.harness import spans

LAYER = "API and wire"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("wire.h2d", "wire.unpack"), spans.stream_ms)
