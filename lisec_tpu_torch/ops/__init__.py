"""Point-cloud operators (port of ``lisec_tpu/ops``): the public names
of the JAX package's ``ops`` that the port has. Importing compiles no
kernel; each CUDA wrapper builds its library at its first launch."""

from lisec_tpu_torch.ops.voxelize import (
    point_cell_ids, voxelize, voxelize_batch)
from lisec_tpu_torch.ops.fps import farthest_point_sampling
from lisec_tpu_torch.ops.ball_query import ball_query
from lisec_tpu_torch.ops.grouping import gather_points, group_points
from lisec_tpu_torch.ops.three_nn import three_interpolate, three_nn
from lisec_tpu_torch.ops.scatter import pillar_scatter, pillar_scatter_max
from lisec_tpu_torch.ops.boxes import (
    boxes_to_corners_bev, decode_boxes, encode_boxes, points_in_rbbox)
from lisec_tpu_torch.ops.rotated_iou import rotated_iou_bev
from lisec_tpu_torch.ops.nms import rotated_nms
from lisec_tpu_torch.ops.range_proj import range_project, range_unproject
from lisec_tpu_torch.ops.knn_refine import knn_refine
from lisec_tpu_torch.ops.sparse_conv import (
    SparseConvSpec, build_output_coords, build_rulebook,
    build_scatter_rulebook, sparse_conv3d, sparse_conv3d_spread)

__all__ = [
    "voxelize", "voxelize_batch", "point_cell_ids",
    "farthest_point_sampling",
    "ball_query",
    "group_points", "gather_points",
    "three_nn", "three_interpolate",
    "pillar_scatter", "pillar_scatter_max",
    "encode_boxes", "decode_boxes", "points_in_rbbox", "boxes_to_corners_bev",
    "rotated_iou_bev",
    "rotated_nms",
    "range_project", "range_unproject",
    "knn_refine",
    "build_output_coords", "build_rulebook", "build_scatter_rulebook",
    "sparse_conv3d", "sparse_conv3d_spread", "SparseConvSpec",
]
