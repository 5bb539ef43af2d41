"""Device-to-host waits of the engine step per window frame: the change
of ``DeviceEngine.host_syncs`` (an exact count in the program) over the
traced window, divided by its frames."""


def read(ctx):
    n = ctx["window_frames"]
    return ctx["syncs"] / n if n else None
