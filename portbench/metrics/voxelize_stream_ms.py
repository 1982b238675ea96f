"""The program's ``voxelize`` span: the voxelizer, points to mean
voxels (sort, bins, the paint kernel); stream ms a request (``infer``
span)."""

from portbench.harness import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "latency_p95_ms"
SOURCE = "program_span"


def read(ctx):
    return spans.per_request(("voxelize",), spans.stream_ms)
