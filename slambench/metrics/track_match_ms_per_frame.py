"""Milliseconds per frame in tracking's matching: the program's
``tracking.match`` spans (the four radius searches with unique assignment
and the projection between refinements), summed over the tracer's stretch
and divided by its frames (``slambench/spans.py``, ``stretch_ctx``)."""


def read(ctx):
    n = ctx.get("tracer_frames")
    s = ctx.get("tracer_span_s", {}).get("tracking.match")
    return 1e3 * s / n if n and s is not None else None
