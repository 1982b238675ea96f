"""API and wire: the host's numpy pack of a request's batch onto the
int16 wire, the program's span ``wire.pack``, host ms a request."""

from portbench.harness import spans

LAYER = "API and wire"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("wire.pack",), spans.host_ms, per="wire.pack")
