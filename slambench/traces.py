"""Reduction of a ``torch.profiler`` trace of the profiled stretch.

From the device's activities (kernels, copies, fills) it takes their
union over time (busy), the window's wall time, the kernel count, the
device operations that took the most time, and the longest idle gaps,
each named after the layer (``record_function`` labels put on by the
harness) and the host operation running at the gap's middle.  The FAST
kernel's launches are kept for its roofline reader.
"""

from __future__ import annotations

from collections import defaultdict

LAYERS = ("frontend", "tracking", "mapping")
TOP = 10


def _device(e) -> bool:
    """A kernel, copy or fill on the card; not the device-side copy of a
    ``record_function`` label, which spans its layer's launches."""
    t = getattr(e, "device_type", None)
    return t is not None and "CUDA" in str(t) and e.name not in LAYERS


def _innermost(spans, t):
    """Name of the shortest span of ``spans`` ((start, end, name), sorted
    by start) that holds time ``t``."""
    best = None
    for s, e, name in spans:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host"


def reduce(prof, window, frames) -> dict:
    """``window``: (first frame, end frame, host seconds) of the stretch."""
    first, end, wall_s = window
    evs = list(prof.events())
    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in evs if _device(e)]
    dev.sort()
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in evs if "CPU" in str(e.device_type))
    layer_spans = [h for h in host if h[2] in LAYERS]
    ops = [h for h in host if h[2].startswith("aten::")]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = []
    for s, e in longest:
        mid = 0.5 * (s + e)
        idle.append([f"{_innermost(layer_spans, mid)}:"
                     f"{_innermost(ops, mid)}", (e - s) * 1e-6])
    fast = [(e - s) * 1e-6 for s, e, name in kernels if "fast_kernel" in name]
    return dict(busy_s=busy * 1e-6, window_s=wall_s,
                kernels=len(kernels), profiled_frames=end - first,
                profiled_range=(first, end), fast_s=fast,
                breakdown=dict(device_ops=[[n, v] for n, v in top_ops],
                               idle_gaps=idle))
