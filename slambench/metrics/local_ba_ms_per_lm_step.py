"""Milliseconds per LM step of local BA: the program's ``mapping.local_ba``
spans (each ``bundle_adjust_impl`` call of ``ba_iterate`` with the
write-back of its result) over the change of ``DeviceEngine.counts``'
``lm_steps`` in the tracer's stretch (``slambench/spans.py``,
``stretch_ctx``).  Nothing where no LM step ran."""


def read(ctx):
    n = ctx.get("tracer_counts", {}).get("lm_steps")
    s = ctx.get("tracer_span_s", {}).get("mapping.local_ba")
    return 1e3 * s / n if n and s is not None else None
