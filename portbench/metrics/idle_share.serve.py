"""Share of the traced serving window in which no kernel, copy or set ran
on the card (the union of device intervals from ``torch.profiler``)."""

LAYER = "device"
UNIT = "%"
MOVES = "clouds_per_s"
SOURCE = "device_trace"


def read(ctx):
    t = ctx["trace"]
    if not t or t.get("busy_s", 0.0) <= 0.0 or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
