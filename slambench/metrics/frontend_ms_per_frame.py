"""Milliseconds per frame in the frontend layer: the harness's span around
the engine's frontend call (``device_engine.extract_features``), bracketed by a device sync on each side, summed over the
spanned half of the traced window and divided by its frames."""


def read(ctx):
    n = ctx["spanned_frames"]
    s = ctx["span_s"].get("frontend")
    return 1e3 * s / n if n and s is not None else None
