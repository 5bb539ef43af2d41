"""Milliseconds per keyframe inserted: the program's
``mapping.insert_keyframe`` spans (``drain_pending``: force cull, cheap
loop closure, point culling, new points, window build) over the change of
``DeviceEngine.counts``' ``keyframes_inserted`` in the tracer's stretch
(``slambench/spans.py``, ``stretch_ctx``).  Nothing where no keyframe was
inserted."""


def read(ctx):
    n = ctx.get("tracer_counts", {}).get("keyframes_inserted")
    s = ctx.get("tracer_span_s", {}).get("mapping.insert_keyframe")
    return 1e3 * s / n if n and s is not None else None
