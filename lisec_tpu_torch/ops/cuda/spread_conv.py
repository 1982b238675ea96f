"""The scatter-form sparse conv's forward in one kernel on Hopper: gather,
per-offset product and spread.

Replaces the pair that ``ops/sparse_conv.py`` ran per sparse conv, one
product per kernel offset written to a (B, K, V_in, Cout) stream and
``spread_accumulate`` routing the stream's rows to the output (the JAX
package's ``_spread_conv`` over ``lisec_tpu/ops/pallas/spread_kernel.py::
spread_accumulate``). It computes

    out[b, t, :] = sum over k = 0..K-1, in that order, of
                   f32(round(W_k^T x[b, in_of[b, k, t], :]))

with ``in_of`` the rulebook's inverse (``in_of[b, k, t]`` the input row n
with ``targets[b, k, n] == t``, else -1, which reads a zero row) and
``round`` to the features' dtype: the pair's own rounding points (its
product was stored in that dtype, its spread added in f32 in k order).
Only the order of each Cin sum is the kernel's own.

The kernel is ``spread_accumulate_kernel_mma`` (bf16, tensor-core
``mma.sync``) or ``spread_accumulate_kernel_fma`` (f32, FMAs, no TF32) in
``csrc/spread_accumulate.cu``, where its design is written up: a block
owns 64 output rows and all Cout channels, gathers for each offset that
names one of its rows those input rows into shared memory and multiplies
them there, skipping the offsets that name none. A caller that holds the
inverse map passes it as ``sources`` (a submanifold conv's): one launch.
Else the spread's ``spread_invert_kernel`` builds it in scratch first:
two launches.

Bound on the card: the map's ints ``4 B K num_out``, the landed input
rows (``landed * Cin * itemsize``, from L2 where rows repeat) and the f32
table ``4 B num_out Cout`` written once, over the memory rate; the
products of the live offsets' tiles over the tensor-core rate. The
per-offset stream of the pair is gone from device memory.

On a CPU tensor ``spread_conv`` computes the plain version,
``spread_conv_reference``: the pair's two steps, ``einsum`` and
``spread_accumulate_reference``. On a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lisec_tpu_torch.ops.cuda import build
from lisec_tpu_torch.ops.cuda.spread_accumulate import (
    spread_accumulate_reference)

# Launches since import: the fused kernel, and the invert kernel of the
# calls that came without ``sources``.
LAUNCHES = 0
INVERT_LAUNCHES = 0

# Output rows a block owns; the kernel skips an offset for a tile of
# this many rows when it names none of them.
TILE_ROWS = 64
MAX_TAPS = 64
MAX_CHANNELS = 128

KERNEL_INFO = {
    "name": "spread_conv",
    "route": "cuda",
    "source": "lisec_tpu_torch/csrc/spread_accumulate.cu",
    "replaces": "the per-offset product and lisec_tpu/ops/pallas/"
                "spread_kernel.py:117 of lisec_tpu/ops/sparse_conv.py::"
                "_spread_conv",
}


def spread_conv_reference(features: torch.Tensor, weights: torch.Tensor,
                          targets: torch.Tensor, *, num_out: int,
                          sources: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: one product per offset, accumulated in f32
    and stored in the features' dtype, then the spread's plain version.
    It takes ``sources`` as the wrapper does and ignores it."""
    z = torch.einsum("bvc,kcd->bkvd", features, weights)
    return spread_accumulate_reference(z.contiguous(), targets,
                                       num_out=num_out)


def skipped_share(in_of: torch.Tensor) -> float:
    """Share of the (tile, offset) pairs that the kernel skips on the
    inverse map ``in_of`` (B, K, num_out): those where no row of the
    ``TILE_ROWS``-row tile has a source."""
    b, k, r = in_of.shape
    pad = -r % TILE_ROWS
    live = torch.nn.functional.pad(in_of >= 0, (0, pad)).view(
        b, k, -1, TILE_ROWS).any(-1)
    return 1.0 - float(live.float().mean())


_conv_fn = None


def _bind() -> None:
    global _conv_fn
    _conv_fn = build.bind("spread_accumulate", "lisec_spread_conv",
                          [ctypes.c_void_p] * 14)


_MAX_ELEMS = 2 ** 31   # the kernel's offsets inside a cloud are 32-bit


def _check(features, weights, targets, num_out, sources):
    """Raise a ValueError on what the kernel does not take."""
    if (features.dtype not in (torch.float32, torch.bfloat16)
            or features.dim() != 3 or weights.dtype != features.dtype
            or weights.dim() != 3 or weights.shape[1] != features.shape[2]):
        raise ValueError(
            f"features (B, V_in, Cin) and weights (K, Cin, Cout) must be "
            f"float32 or bfloat16 of one dtype, got "
            f"{tuple(features.shape)} {features.dtype} and "
            f"{tuple(weights.shape)} {weights.dtype}")
    b, v_in, cin = features.shape
    k, _, cout = weights.shape
    if targets.dtype != torch.int32 or targets.shape != (b, k, v_in):
        raise ValueError(f"targets must be ({b}, {k}, {v_in}) int32, got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    if sources is not None and (sources.dtype != torch.int32
                                or sources.shape != (b, k, num_out)):
        raise ValueError(f"sources must be ({b}, {k}, {num_out}) int32, got "
                         f"{tuple(sources.shape)} {sources.dtype}")
    for name, a in (("weights", weights), ("targets", targets),
                    ("sources", sources)):
        if a is not None and a.device != features.device:
            raise ValueError(f"{name} is on {a.device}, features on "
                             f"{features.device}")
    if min(b, v_in, cin, k, cout, num_out) < 1:
        raise ValueError(f"need B, V_in, Cin, K, Cout, num_out >= 1, got "
                         f"{b}, {v_in}, {cin}, {k}, {cout}, {num_out}")
    if (b > 65535 or k > MAX_TAPS or max(cin, cout) > MAX_CHANNELS
            or k * v_in >= _MAX_ELEMS or k * num_out >= _MAX_ELEMS
            or v_in * cin >= _MAX_ELEMS or num_out * cout >= _MAX_ELEMS):
        raise ValueError(
            f"the kernel takes B <= 65535, K <= {MAX_TAPS}, Cin and Cout "
            f"<= {MAX_CHANNELS} and 32-bit offsets inside a cloud, got "
            f"B {b}, K {k}, Cin {cin}, Cout {cout}, V_in {v_in}, "
            f"num_out {num_out}")
    if not (features.is_contiguous() and weights.is_contiguous()
            and targets.is_contiguous()
            and (sources is None or sources.is_contiguous())):
        raise ValueError("features, weights, targets and sources must be "
                         "contiguous")


def spread_conv(features: torch.Tensor, weights: torch.Tensor,
                targets: torch.Tensor, *, num_out: int,
                sources: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, num_out, Cout) f32: the scatter-form sparse conv of features
    (B, V_in, Cin) by weights (K, Cin, Cout) of the same dtype (f32 or
    bf16) under the scatter rulebook ``targets`` (B, K, V_in) int32,
    whose ids inside ``[0, num_out)`` are distinct per (b, k); other ids
    drop their row. ``sources`` (B, K, num_out) int32, where the caller
    holds it, is the rulebook's exact inverse: the kernel then reads it
    instead of building one. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    global LAUNCHES, INVERT_LAUNCHES
    _check(features, weights, targets, num_out, sources)
    if not features.is_cuda:
        return spread_conv_reference(features, weights, targets,
                                     num_out=num_out)
    b, v_in, cin = features.shape
    k, _, cout = weights.shape
    if _conv_fn is None:
        _bind()
    in_of = (features.new_empty(b, k, num_out, dtype=torch.int32)
             if sources is None else sources)
    out = features.new_empty(b, num_out, cout, dtype=torch.float32)
    err = _conv_fn(
        features.data_ptr(), weights.data_ptr(), targets.data_ptr(),
        in_of.data_ptr(), out.data_ptr(), b, k, v_in, cin, cout, num_out,
        features.dtype == torch.bfloat16, sources is not None,
        build.stream_of(features))
    if err != 0:
        raise RuntimeError(f"spread_conv kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    INVERT_LAUNCHES += sources is None
    return out
