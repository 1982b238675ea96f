"""The control's precision: the reference with every operand of a linear
layer or conv rounded to the next precision below the configuration's.

The configurations compute in bfloat16, so the control rounds to fp8
(e4m3) with one scale per tensor (its largest magnitude onto e4m3's
largest finite value, 448), as fp8 inference does, and computes on in
float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (t.float() / scale).to(torch.float8_e4m3fn)
    return q.float() * scale


CASTS = {"bfloat16": fp8_e4m3}


def control_cast(cfg) -> callable:
    """The cast one step below the configuration's compute dtype."""
    dtype = cfg["model"]["params"].get("dtype", "float32")
    if dtype not in CASTS:
        raise ValueError(f"no control precision below {dtype}")
    return CASTS[dtype]
