"""Kernel launches per frame: kernels (not copies or fills) in the
profiled stretch of the traced window, over its frames."""


def read(ctx):
    n = ctx.get("profiled_frames")
    return ctx["kernels"] / n if n else None
