"""``pillar_canvas_fused``'s share of its roofline: the least time of its
calls in the traced window (each input read once, the canvas written once,
``work.encoder_bound`` at the captured batches' point and pillar counts)
over the device time of its two kernels (``cells_kernel``,
``canvas_kernel``) in the trace."""

LAYER = "kernels"
UNIT = "%"
MOVES = "clouds_per_s"
SOURCE = "device_trace"
KERNELS = ("cells_kernel", "canvas_kernel")


def read(ctx):
    t, c = ctx["trace"], ctx["counters"]
    if not t or not c.get("encoder_bound_s"):
        return None
    spent = sum(v for k, v in t["device_s_by_name"].items()
                if any(n in k for n in KERNELS))
    if spent <= 0.0:
        return None
    return 100.0 * c["encoder_bound_s"] / spent
