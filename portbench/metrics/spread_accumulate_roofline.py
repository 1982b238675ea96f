"""``spread_accumulate``'s share of its roofline over a SECOND predict's
nine calls: their least time (``work.spread_bound_s`` at the captured
batches' rulebook pair counts) over the device time of its kernels
(``spread_accumulate_kernel``, and ``spread_invert_kernel`` where a call
builds its inverse map) in the trace."""

LAYER = "kernels"
UNIT = "%"
MOVES = "clouds_per_s"
SOURCE = "device_trace"
KERNELS = ("spread_accumulate_kernel", "spread_invert_kernel")


def read(ctx):
    t, c = ctx["trace"], ctx["counters"]
    if not t or not c.get("spread_bound_s"):
        return None
    spent = sum(v for k, v in t["device_s_by_name"].items()
                if any(n in k for n in KERNELS))
    if spent <= 0.0:
        return None
    return 100.0 * c["spread_bound_s"] / spent
