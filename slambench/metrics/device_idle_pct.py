"""Share of the profiled stretch's wall time in which no operation ran on
the device: the window less the union of the device's activity intervals
from ``torch.profiler``.  The stretch has no stage syncs."""


def read(ctx):
    w = ctx.get("window_s")
    return 100.0 * (1.0 - ctx["busy_s"] / w) if w else None
