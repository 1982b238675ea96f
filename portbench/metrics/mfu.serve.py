"""Model FLOPs of the clouds served in the traced window (counted from the
configuration's widths by its counter, ``portbench/counters/``) over the
window's seconds, as a share of the card's bf16 peak (989 TFLOP/s)."""

from portbench.harness.work import PEAK_BF16_FLOPS

LAYER = "model step"
UNIT = "%"
MOVES = "clouds_per_s"
SOURCE = "device_trace"


def read(ctx):
    t, c = ctx["trace"], ctx["counters"]
    if not t or t["window_s"] <= 0.0 or not c.get("model_flops_traced"):
        return None
    return 100.0 * c["model_flops_traced"] / t["window_s"] / PEAK_BF16_FLOPS
