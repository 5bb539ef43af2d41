"""Milliseconds per loop attempt: the program's ``mapping.loop`` spans
(``try_loop``: candidates, and where one passes its gates the detection
and any correction) over the change of ``DeviceEngine.counts``'
``loop_detections`` plus ``loop_no_candidates`` in the tracer's stretch
(``slambench/spans.py``, ``stretch_ctx``).  Nothing where no attempt
ran."""


def read(ctx):
    c = ctx.get("tracer_counts", {})
    if "loop_detections" not in c or "loop_no_candidates" not in c:
        return None
    n = c["loop_detections"] + c["loop_no_candidates"]
    s = ctx.get("tracer_span_s", {}).get("mapping.loop")
    return 1e3 * s / n if n and s is not None else None
