"""Milliseconds per frame the engine step waited on the device: the
program's ``sync`` spans (each blocking read of ``DeviceEngine._read`` and
the facade's wait on its copied output rows), summed over a stretch run
with the program's tracer on and no stage syncs or profiler, over its
frames (``slambench/spans.py``, ``stretch_ctx``)."""


def read(ctx):
    n = ctx.get("tracer_frames")
    s = ctx.get("tracer_span_s", {}).get("sync")
    return 1e3 * s / n if n and s is not None else None
