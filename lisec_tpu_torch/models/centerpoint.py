"""CenterPoint with the residual sparse voxel encoder (Yin, Zhou and
Kraehenbuehl, "Center-based 3D Object Detection and Tracking", CVPR 2021;
the voxel network of OpenPCDet's
``tools/cfgs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml``).

The JAX package has no CenterPoint; this model exists in the port only.

Mean-VFE voxels -> ``VoxelResBackBone8x``: a submanifold conv into 16
channels, two residual ``SparseBasicBlock``s at each of 16, 32, 64 and
128 channels with a strided sparse conv between levels, and a
``conv_out`` of kernel (3, 1, 1) and stride (2, 1, 1) that leaves two z
layers; densified and its z folded into channels (``c * D + d``, as
OpenPCDet's ``HeightCompression``) -> the BEV backbone and neck the
anchor detectors use (``BEVBackbone``) -> ``CenterHead``: a shared 3x3
conv, then per task six heads (centre offset, height, log size, heading
as cos and sin, velocity, heatmap), each a 3x3 conv + BatchNorm + ReLU
and a 3x3 conv to its outputs.

Every sparse conv runs as SECOND's do (``models/second.py::SparseConv3D``:
a scatter rulebook and the fused sparse-conv kernel), with the tap
count and the output set of its own kernel, stride and padding
(``ops/sparse_conv.py``); the voxel list reaches its dense grid through
the paint kernel (``segment_sum_dense``). Voxel-list budgets per level
are static config; the input grid's z has one layer more than the voxel
grid's, as spconv's sparse shape does.

The head's 36 first convs read one map, so they run as one conv into
their channels side by side, and its 36 output convs as one grouped
conv; the parameters stay per head. Parameters are f32 and cast to the
compute dtype per layer.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lisec_tpu_torch.models.common import BN_EPS, reset_parameters
from lisec_tpu_torch.models.pointpillars import BEVBackbone
from lisec_tpu_torch.models.second import SparseConv3D
from lisec_tpu_torch.ops.scatter import segment_sum_dense
from lisec_tpu_torch.ops.sparse_conv import (
    SparseConvSpec, build_output_coords, build_scatter_rulebook,
    submanifold_sources)
from lisec_tpu_torch.utils import prng
from lisec_tpu_torch.utils.profiling import span

# The heads of a task in the order their outputs are laid out, with
# their widths; ``hm`` has the task's class count.
HEADS = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2),
         ("vel", 2), ("hm", None))
# The heatmap's initial bias, -log((1 - pi) / pi) at pi = 0.1 (OpenPCDet's
# ``init_bias``).
HM_BIAS_INIT = -2.19
# Strided convs between levels: (kernel, stride, padding), and conv_out.
DOWN = (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
        ((3, 3, 3), (2, 2, 2), (0, 1, 1)))
CONV_OUT = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
BLOCKS_PER_LEVEL = 2


def _taps(kernel: Tuple[int, int, int]) -> int:
    return kernel[0] * kernel[1] * kernel[2]


class VoxelResBackBone8x(nn.Module):
    """Residual sparse encoder, 8x down in y and x: voxel list -> BEV map
    (B, C_out * D, ny / 8, nx / 8), channel ``c * D + d``.

    ``grid`` is the sparse shape (nz, ny, nx); ``level_budgets`` the
    static list size of each level's output set (levels 0-3, then
    ``conv_out``'s). ``sparse`` holds the 21 convs in their order:
    ``conv_input``, per level (the strided conv into it from level 1 on)
    the two blocks' two convs each, then ``conv_out``."""

    def __init__(self, in_channels: int, grid: Tuple[int, int, int],
                 channels: Sequence[int] = (16, 32, 64, 128),
                 out_channels: int = 128,
                 level_budgets: Sequence[int] = (160000, 160000, 160000,
                                                 160000, 64800),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(channels) != len(DOWN) + 1:
            raise ValueError(f"{len(DOWN) + 1} levels, got {channels}")
        if len(level_budgets) != len(channels) + 1:
            raise ValueError(f"need {len(channels) + 1} level budgets, got "
                             f"{level_budgets}")
        self.grid = tuple(grid)
        self.channels = tuple(channels)
        self.level_budgets = tuple(int(b) for b in level_budgets)
        self.dtype = dtype
        self.sparse = nn.ModuleList()
        self.sparse.append(SparseConv3D(in_channels, channels[0], dtype))
        for level, ch in enumerate(channels):
            if level:
                self.sparse.append(SparseConv3D(
                    channels[level - 1], ch, dtype,
                    num_offsets=_taps(DOWN[level - 1][0])))
            for _ in range(BLOCKS_PER_LEVEL):
                self.sparse.append(SparseConv3D(ch, ch, dtype,
                                                conv_bias=True))
                self.sparse.append(SparseConv3D(ch, ch, dtype,
                                                conv_bias=True, relu=False))
        self.sparse.append(SparseConv3D(channels[-1], out_channels, dtype,
                                        num_offsets=_taps(CONV_OUT[0])))
        self.out_channels = out_channels

    def specs(self) -> List[SparseConvSpec]:
        """The strided convs' geometry, level 1's first, ``conv_out``'s
        last."""
        out, grid = [], self.grid
        for k, s, p in DOWN + (CONV_OUT,):
            out.append(SparseConvSpec(k, s, p, grid))
            grid = out[-1].grid_out
        return out

    @property
    def out_grid(self) -> Tuple[int, int, int]:
        return self.specs()[-1].grid_out

    def _strided(self, conv, x, coords, num, spec, budget):
        """One strided conv onto its output set: (x, coords, num, valid)
        of the output list."""
        dev = x.device
        with span("rulebook", dev):
            out_coords, out_num = build_output_coords(coords, num, spec,
                                                      max_out=budget)
            rb = build_scatter_rulebook(coords, num, out_coords, out_num,
                                        spec)
        valid = (torch.arange(out_coords.shape[1], device=dev)
                 < out_num[:, None])
        return conv(x, rb, valid), out_coords, out_num, valid

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                num_voxels: torch.Tensor) -> torch.Tensor:
        """feats (B, V, C), coords (B, V, 3) int32 [z, y, x] sorted by
        cell id, num_voxels (B,) -> the BEV map. Under a profiler, one
        span ``rulebook`` a rulebook built (a level's submanifold
        rulebook and its inverse; a strided conv's output set and
        rulebook)."""
        b, v, _ = feats.shape
        dev = feats.device
        convs = iter(self.sparse)
        specs = self.specs()
        grid = self.grid
        x, cur_coords, cur_num = feats, coords, num_voxels
        valid = torch.arange(v, device=dev) < num_voxels[:, None]
        for level in range(len(self.channels)):
            if level:
                spec = specs[level - 1]
                x, cur_coords, cur_num, valid = self._strided(
                    next(convs), x, cur_coords, cur_num, spec,
                    self.level_budgets[level])
                grid = spec.grid_out
            subm = SparseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1), grid)
            with span("rulebook", dev):
                rb = build_scatter_rulebook(cur_coords, cur_num, cur_coords,
                                            cur_num, subm)
                sources = submanifold_sources(rb)
            if not level:
                x = next(convs)(x, rb, valid, sources)     # conv_input
            for _ in range(BLOCKS_PER_LEVEL):
                h = next(convs)(x, rb, valid, sources)
                x = torch.relu(next(convs)(h, rb, valid, sources) + x)
        x, cur_coords, _, valid = self._strided(
            next(convs), x, cur_coords, cur_num, specs[-1],
            self.level_budgets[-1])

        # Lay the list (sorted, distinct cells) onto its dense grid.
        nz, ny, nx = specs[-1].grid_out
        lin = (cur_coords[..., 0] * ny + cur_coords[..., 1]) * nx \
            + cur_coords[..., 2]
        lin = torch.where(valid, lin, nz * ny * nx).to(torch.int32)
        tab, _ = segment_sum_dense(x, lin, nz * ny * nx)
        x = tab.view(b, nz, ny, nx, -1).permute(0, 4, 1, 2, 3)
        return x.reshape(b, -1, ny, nx).to(self.dtype)


class ConvBN(nn.Module):
    """Parameters of a 3x3 conv with a bias (``conv_bias``) followed by a
    BatchNorm; with ``bn=False`` a plain conv with its bias (``bias``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bn: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, 3, 3))
        if bn:
            self.conv_bias = nn.Parameter(torch.zeros(out_channels))
            self.scale = nn.Parameter(torch.ones(out_channels))
            self.register_buffer("mean", torch.zeros(out_channels))
            self.register_buffer("var", torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))


def _conv_bn_relu(x: torch.Tensor, w: torch.Tensor, conv_bias, scale, bias,
                  mean, var, dtype: torch.dtype) -> torch.Tensor:
    """3x3 conv (padding 1) in ``dtype``, its bias and the BatchNorm with
    running statistics in f32, ReLU, back to ``dtype``."""
    y = F.conv2d(x.to(dtype), w.to(dtype), padding=1).float() \
        + conv_bias.view(-1, 1, 1)
    mul = torch.rsqrt(var + BN_EPS) * scale
    y = (y - mean.view(-1, 1, 1)) * mul.view(-1, 1, 1) + bias.view(-1, 1, 1)
    return torch.relu(y).to(dtype)


class CenterHead(nn.Module):
    """Shared 3x3 conv + BatchNorm + ReLU, then per task the six heads of
    ``HEADS``. ``tasks`` holds each task's class count. Returns f32 maps
    (B, T, c, H, W) by head; ``hm`` has the largest class count, a
    smaller task's extra channels at -inf."""

    def __init__(self, in_channels: int, tasks: Sequence[int],
                 channels: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = tuple(int(t) for t in tasks)
        self.shared = ConvBN(in_channels, channels)
        self.tasks = nn.ModuleList()
        for n in self.num_classes:
            heads = nn.ModuleDict()
            for name, width in HEADS:
                heads[name] = nn.ModuleDict({
                    "conv": ConvBN(channels, channels),
                    "out": ConvBN(channels, width or n, bn=False)})
            self.tasks.append(heads)
        self.width = max(3, *self.num_classes)
        pad = torch.zeros(len(tasks), max(self.num_classes))
        for t, n in enumerate(self.num_classes):
            pad[t, n:] = float("-inf")
        self.register_buffer("hm_pad", pad, persistent=False)
        self._fused = (None, None)

    def _fused_params(self):
        """The 36 branches' parameters side by side: the first convs'
        (kernel, conv bias, BatchNorm), and the output convs' kernels and
        biases, each zero-padded to ``width`` outputs. Without autograd
        they are kept until a parameter or statistic changes or moves."""
        branches = [h for task in self.tasks for h in task.values()]
        tensors = [t for h in branches
                   for t in (*h.parameters(), *h.buffers())]
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._fused[0] == key and not torch.is_grad_enabled():
            return self._fused[1]
        convs = [h["conv"] for h in branches]
        first = tuple(torch.cat([getattr(c, n) for c in convs])
                      for n in ("weight", "conv_bias", "scale", "bias",
                                "mean", "var"))
        outs = [h["out"] for h in branches]
        w = torch.cat([F.pad(o.weight, (0, 0, 0, 0, 0, 0, 0,
                                        self.width - o.weight.shape[0]))
                       for o in outs])
        bias = torch.cat([F.pad(o.bias, (0, self.width - o.bias.shape[0]))
                          for o in outs])
        fused = (first, w, bias)
        self._fused = (None if torch.is_grad_enabled() else key, fused)
        return fused

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, hh, ww = x.shape
        s = self.shared
        x = _conv_bn_relu(x, s.weight, s.conv_bias, s.scale, s.bias, s.mean,
                          s.var, self.dtype)
        first, w, bias = self._fused_params()
        h = _conv_bn_relu(x, *first, self.dtype)
        n_branch = w.shape[0] // self.width
        y = F.conv2d(h, w.to(self.dtype), bias.to(self.dtype), padding=1,
                     groups=n_branch).float()
        y = y.view(b, len(self.tasks), len(HEADS), self.width, hh, ww)
        out = {}
        for i, (name, width) in enumerate(HEADS):
            out[name] = y[:, :, i, :width or max(self.num_classes)]
        out["hm"] = out["hm"] + self.hm_pad[None, :, :, None, None]
        return out


class CenterPointNet(nn.Module):
    """Mean-VFE voxels -> ``VoxelResBackBone8x`` -> BEV backbone ->
    ``CenterHead``. ``voxels`` is (B, P, C) per-voxel mean features
    (``voxelize_mean_batch``). Under a profiler, the spans ``encoder``
    (the sparse encoder to the BEV map, its ``rulebook`` spans inside)
    and ``center.head``."""

    FLAX_KEYS = "centerpoint"
    # Kernels N(0, 2 / fan_in) (OpenPCDet's kaiming init), conv biases 0,
    # the heatmap's output bias at ``HM_BIAS_INIT``.
    FLAX_INITS = (
        (r"/kernel$", prng.variance_scaling(2.0, "fan_in",
                                            "truncated_normal")),
        (r"/conv_bias$", prng.zeros),
        (r"^params/head/tasks/\d+/hm/out/bias$",
         prng.constant(HM_BIAS_INIT)))

    def __init__(self, grid_size: Tuple[int, int, int], tasks: Sequence[int],
                 in_channels: int = 5,
                 encoder_channels: Sequence[int] = (16, 32, 64, 128),
                 encoder_out_channels: int = 128,
                 level_budgets: Sequence[int] = (160000, 160000, 160000,
                                                 160000, 64800),
                 bev_layers: Sequence[int] = (5, 5),
                 bev_filters: Sequence[int] = (128, 256),
                 bev_strides: Sequence[int] = (1, 2),
                 bev_up_strides: Sequence[int] = (1, 2),
                 bev_up_filters: Sequence[int] = (256, 256),
                 head_channels: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nx, ny, nz = grid_size
        self.dtype = dtype
        # spconv's sparse shape: one z layer above the voxel grid.
        self.encoder = VoxelResBackBone8x(
            in_channels, (nz + 1, ny, nx), encoder_channels,
            encoder_out_channels, level_budgets, dtype)
        bev_channels = self.encoder.out_grid[0] * encoder_out_channels
        self.backbone = BEVBackbone(
            bev_channels, bev_layers, bev_strides, bev_filters,
            bev_up_strides, bev_up_filters, dtype=dtype)
        self.head = CenterHead(sum(bev_up_filters), tasks, head_channels,
                               dtype)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor, num_voxels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        dev = voxels.device
        with span("encoder", dev):
            bev = self.encoder(voxels.to(self.dtype), coords, num_voxels)
        x = self.backbone(bev)
        with span("center.head", dev):
            return self.head(x)

    def reset_parameters(self, seed: int) -> None:
        """Initial weights from ``seed`` (``models.common.
        reset_parameters``: each parameter drawn in its flax layout under
        its key, by ``FLAX_INITS``)."""
        reset_parameters(self, seed)
