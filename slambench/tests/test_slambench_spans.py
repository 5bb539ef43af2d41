"""The span readers and ``slambench/spans.py`` on hand-made inputs: a
stretch's spans and counter changes, and a profiled stretch's events."""

from types import SimpleNamespace

import pytest

from mageslam_tpu_torch.utils.tracing import Span
from slambench import harness, spans

FRAME_READERS = {"sync_wait_ms_per_frame": "sync",
                 "track_match_ms_per_frame": "tracking.match",
                 "pose_refine_ms_per_frame": "tracking.refine"}
UNIT_READERS = {"local_ba_ms_per_lm_step": ("mapping.local_ba",
                                            "lm_steps"),
                "keyframe_insert_ms_per_keyframe": (
                    "mapping.insert_keyframe", "keyframes_inserted")}
SPAN_S = {"sync": 0.012, "tracking.match": 0.9, "tracking.refine": 0.3,
          "mapping.local_ba": 1.6, "mapping.insert_keyframe": 0.45,
          "mapping.loop": 0.2}
COUNTS = dict(lm_steps=64, keyframes_inserted=3, loop_detections=1,
              loop_no_candidates=3)


def ctx(**changes):
    c = dict(tracer_frames=12, tracer_span_s=dict(SPAN_S),
             tracer_counts=dict(COUNTS))
    c.update(changes)
    return c


@pytest.mark.parametrize("name", sorted(FRAME_READERS))
def test_per_frame_readers(name):
    read = harness.load_reader(name)
    assert read(ctx()) == pytest.approx(1e3 * SPAN_S[FRAME_READERS[name]]
                                        / 12)
    assert read(ctx(tracer_frames=0)) is None
    assert read(ctx(tracer_span_s={})) is None
    assert read({}) is None           # a program without the tracer


@pytest.mark.parametrize("name", sorted(UNIT_READERS))
def test_per_unit_readers(name):
    read = harness.load_reader(name)
    span, counter = UNIT_READERS[name]
    assert read(ctx()) == pytest.approx(1e3 * SPAN_S[span] / COUNTS[counter])
    assert read(ctx(tracer_counts=dict(COUNTS, **{counter: 0}))) is None
    assert read(ctx(tracer_counts={})) is None
    assert read({}) is None


def test_loop_reader_counts_both_kinds_of_attempt():
    read = harness.load_reader("loop_detection_ms_per_attempt")
    assert read(ctx()) == pytest.approx(1e3 * 0.2 / 4)
    assert read(ctx(tracer_counts=dict(COUNTS, loop_detections=0,
                                       loop_no_candidates=0))) is None
    assert read(ctx(tracer_counts=dict(lm_steps=3))) is None
    assert read({}) is None


# a frame [0, 100] us with mapping [10, 60] and, inside it, sync [40, 50]
SPANS = [Span("frame", 0, 100_000, -1, 5), Span("mapping", 10_000, 60_000,
                                                0, 5),
         Span("sync", 40_000, 50_000, 1, 5)]


def test_stretch_ctx_and_table():
    before = dict(lm_steps=8, keyframes_inserted=1)
    after = dict(lm_steps=24, keyframes_inserted=2, force_culls=0)
    c = spans.stretch_ctx(SPANS, 2, before, after)
    assert c["tracer_frames"] == 2
    assert c["tracer_counts"] == dict(lm_steps=16, keyframes_inserted=1)
    assert c["tracer_span_s"] == pytest.approx(
        dict(frame=1e-4, mapping=5e-5, sync=1e-5))
    assert c["tracer_self_s"] == pytest.approx(
        {"frame": 5e-5, "frame/mapping": 4e-5, "frame/mapping/sync": 1e-5})
    rows = spans.span_table(c, None, 6)
    assert [r[0] for r in rows] == ["frame", "frame/mapping",
                                    "frame/mapping/sync"]
    assert rows[0][1] == pytest.approx(0.025) and rows[0][2] is None


def ev(name, dev, start, end, id_=0):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{dev}",
                           time_range=SimpleNamespace(start=start, end=end),
                           id=id_)


def test_attribution_of_kernels_and_idle_time():
    events = [
        ev(spans.ANCHOR, "CPU", 0.0, 2.0),
        ev("aten::mul", "CPU", 19.0, 22.0),
        ev("cudaLaunchKernel", "CPU", 20.0, 21.0, 5),
        ev("cudaLaunchKernel", "CPU", 45.0, 46.0, 6),
        ev("kernel_a", "CUDA", 30.0, 35.0, 5),
        ev("kernel_b", "CUDA", 47.0, 70.0, 6),
        ev("kernel_c", "CUDA", 80.0, 90.0, 7),
        ev("Memcpy HtoD", "CUDA", 85.0, 86.0, 8),
    ]
    # the anchor's host read, 1 us into the profiler's clock: offset 0
    att = spans.attribute(events, SPANS, anchor_ns=1000)
    assert att["kernels"] == {"frame/mapping": 1, "frame/mapping/sync": 1,
                              "(launch not found)": 1}
    # idle (35, 47): mapping 35-40, its sync 40-47; idle (70, 80): frame
    assert att["idle_us"] == pytest.approx(
        {"frame/mapping": 5.0, "frame/mapping/sync": 7.0, "frame": 10.0,
         spans.OUTSIDE: 0.0})
    assert att["gap_spans"] == [["frame/mapping/sync", pytest.approx(0.012)],
                                ["frame", pytest.approx(0.010)]]
    with pytest.raises(ValueError):
        spans.attribute(events[1:], SPANS, anchor_ns=1000)
