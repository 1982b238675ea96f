"""API and wire: a request's mean wall time (packing on the host, the copy
to the card, dequantizing, outputs back to the host) less the
device-resident ``predict`` of the same requests' batches (each batch's
weighted by how often they sent it), ms a request. Requests under the
profiler are left out."""

LAYER = "API and wire"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    s = ctx["spans"]
    if s.get("request_s") is None or s.get("predict_s") is None:
        return None
    return 1e3 * (s["request_s"] - s["predict_s"])
