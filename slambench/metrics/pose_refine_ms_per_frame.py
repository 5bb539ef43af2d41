"""Milliseconds per frame in tracking's pose refinements: the program's
``tracking.refine`` spans (the two ``pnp.refine_pose`` calls), summed over
the tracer's stretch and divided by its frames (``slambench/spans.py``,
``stretch_ctx``)."""


def read(ctx):
    n = ctx.get("tracer_frames")
    s = ctx.get("tracer_span_s", {}).get("tracking.refine")
    return 1e3 * s / n if n and s is not None else None
