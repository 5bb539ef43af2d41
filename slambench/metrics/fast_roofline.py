"""The FAST kernel's share of its roofline: the least time its launches
in the profiled stretch could take (``roofline.least_seconds``, from each
frame's shape and early-out candidates) over their device time in the
trace.  Nothing is read where the launches do not pair one to one with
the stretch's frames."""

import torch

from slambench import roofline


def read(ctx):
    times = ctx.get("fast_s")
    first, end = ctx.get("profiled_range", (0, 0))
    if not times or len(times) != end - first:
        return None
    fe = ctx["settings"].mono.camera.features
    least = 0.0
    for f in ctx["frames"][first:end]:
        img = torch.as_tensor(f).to(torch.float32)
        least += roofline.least_seconds(
            img.shape[0], img.shape[1],
            roofline.candidates(img, float(fe.fast_threshold)))
    return 100.0 * least / sum(times)
