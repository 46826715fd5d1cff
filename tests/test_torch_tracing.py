"""The port's tracing module (``elevation_mapping_cupy_torch.tracing``): span
nesting, parents and request ids, the bounded ring, the profiler ranges and
their clock, the span tree of one frame through the mapping service, and the
``blocking_transfers`` counter.

Imports no JAX, so the card's case also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from elevation_mapping_cupy_torch import MapConfig, tracing
from elevation_mapping_cupy_torch.runtime.service import MappingService, SensorFrame

CFG = MapConfig(resolution=0.1, map_length=2.0, max_ray_length=1.0, max_points=1024)
EYE = np.eye(3, dtype=np.float32)
STAGES = ["core.associate", "core.error_counting", "core.drift", "core.fusion", "raycast.polar_cube",
          "raycast.polar_evaluate", "core.average", "core.overlap_clearance", "core.dilation",
          "core.traversability", "core.normals"]
# the blocking transfers of each call (PERF.md §3): an update uploads its
# points, their mask, R and t, and its two noise scalars; a pose uploads the
# position and R; a publish reads its layers back once
PER_UPDATE, PER_POSE, PER_PUBLISH = 6, 2, 1


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _since():
    return time.perf_counter_ns()


def _children(of, among):
    return [s for s in among if s.parent == of.sid]


def _cloud(seed=0, n=800):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.1, 0.2, n)
    pts[:5] = np.nan
    return pts


def _service(device="cpu", publish=True):
    svc = MappingService(CFG, device=device, variance_fps=5.0, time_fps=10.0)
    if publish:
        svc.add_publisher("map", ["elevation", "variance", "traversability"], 5.0, lambda out: None)
    return svc


def _frame(stamp, seed=0):
    return SensorFrame(kind="pointcloud", channels=("x", "y", "z"), data=_cloud(seed), R=EYE,
                       t=np.array([0.0, 0.0, 0.5], np.float32), stamp=stamp)


def test_nesting_parents_and_request_ids():
    t0 = _since()
    with tracing.span("outer", tag=1) as outer:
        with tracing.span("inner") as inner:
            with tracing.span("leaf", rid="frame-9") as leaf:
                pass
        with tracing.span("sibling") as sibling:
            pass
    with tracing.span("next") as nxt:
        pass
    got = tracing.spans(t0)
    assert [s.name for s in got] == ["leaf", "inner", "sibling", "outer", "next"]
    assert outer.parent is None and nxt.parent is None
    assert inner.parent == outer.sid and sibling.parent == outer.sid and leaf.parent == inner.sid
    assert inner.rid == sibling.rid == outer.rid
    assert leaf.rid == "frame-9"
    assert nxt.rid != outer.rid
    assert outer.attrs == {"tag": 1}
    assert outer.t0_ns <= inner.t0_ns <= leaf.t0_ns <= leaf.t1_ns <= inner.t1_ns <= sibling.t0_ns
    assert sibling.t1_ns <= outer.t1_ns <= nxt.t0_ns
    assert {s.thread for s in got} == {threading.get_ident()}
    assert [s.name for s in _children(outer, got)] == ["inner", "sibling"]


def test_spans_on_two_threads_do_not_nest_across():
    t0 = _since()
    seen = {}

    def worker():
        with tracing.span("worker") as s:
            seen["worker"] = s

    with tracing.span("main") as main:
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert seen["worker"].parent is None and seen["worker"].rid != main.rid
    assert seen["worker"].thread != main.thread
    assert {s.name for s in tracing.spans(t0)} == {"main", "worker"}


def test_the_ring_is_bounded():
    assert tracing.RING_SIZE == 65536 and tracing._ring.maxlen == tracing.RING_SIZE
    for _ in range(tracing.RING_SIZE + 10):
        with tracing.span("fill"):
            pass
    got = tracing.spans()
    assert len(got) == tracing.RING_SIZE and all(s.name == "fill" for s in got)
    assert got[-1].sid - got[0].sid == tracing.RING_SIZE - 1


def test_summary_self_time_and_transfers_of_children():
    t0 = _since()
    with tracing.span("parent") as parent:
        tracing.upload(np.zeros(3, np.float32), "cpu")
        with tracing.span("child") as child:
            time.sleep(0.002)
            tracing.upload(1.0, "cpu")
            tracing.read_back(torch.zeros(2))
    assert child.transfers == 2 and parent.transfers == 3
    table = tracing.summary(tracing.spans(t0))
    assert list(table) == ["child", "parent"]
    assert table["parent"]["count"] == 1 and table["parent"]["stream_ms"] is None
    assert table["parent"]["self_ms"] == pytest.approx(parent.ms - child.ms)
    assert table["child"]["self_ms"] == pytest.approx(child.ms) and child.ms >= 2.0


def test_upload_counts_only_copies():
    before = tracing.blocking_transfers()
    x = torch.ones(3)
    assert tracing.upload(x, torch.device("cpu")) is x
    assert tracing.upload(x, "cpu", torch.float64).dtype == torch.float64
    assert tracing.blocking_transfers() == before
    assert tracing.upload(np.arange(3), "cpu", torch.float32).tolist() == [0.0, 1.0, 2.0]
    assert tracing.upload(0.5, "cpu", torch.float32).item() == 0.5
    out = tracing.read_back(x, copy=True)
    out[0] = 7
    assert x[0] == 1 and tracing.blocking_transfers() == before + 3


class _Counting:
    """Stands in for ``record_function`` or ``torch.cuda.Event`` and counts
    what is made of it."""

    def __init__(self, made):
        self.made = made

    def __call__(self, *a, **kw):
        self.made.append(a)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def record(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.5


def test_no_range_and_no_event_without_a_profiler(monkeypatch):
    ranges, events = [], []
    monkeypatch.setattr(torch.profiler, "record_function", _Counting(ranges))
    monkeypatch.setattr(torch.cuda, "Event", _Counting(events))
    t0 = _since()
    with tracing.span("stage", stream=True):
        with tracing.span("host"):
            pass
    assert ranges == [] and events == []
    assert all(s.stream_ms is None for s in tracing.spans(t0))
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("stage", stream=True):
            with tracing.span("host"):
                pass
    assert [a[0] for a in ranges] == ["stage", "host"]
    assert len(events) == 2      # one pair, for the stream span only
    stage = [s for s in tracing.spans(t0) if s.name == "stage"]
    assert [s.stream_ms for s in stage] == [None, 1.5]


def test_profiler_ranges_start_at_their_ring_t0():
    """The program's ranges in a profiler trace, moved onto the host clock
    by a ``bench.anchor`` range as the benchmark's tracer does it, start
    within 0.1 ms of the spans' ``t0_ns``."""
    from elevation_mapping_cupy_torch.mapper import ElevationMap

    em = ElevationMap(CFG, device="cpu")
    em.input_pointcloud(_cloud(), ["x", "y", "z"], EYE, np.array([0, 0, 0.5]), 0.0, 0.0)
    # the tracer's warm-up: a process's first range costs ~1 ms more than
    # the next, which would move the anchor's start by as much
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("bench.warm"):
            pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function("bench.anchor"):
        anchor = time.perf_counter_ns()
    t0 = _since()
    for i in range(2):
        em.move_to(np.array([0.05 * i, 0.0, 0.0]), EYE)
        em.input_pointcloud(_cloud(i), ["x", "y", "z"], EYE, np.array([0, 0, 0.5]), 0.0, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prof.stop()
    ring = tracing.spans(t0)
    events = prof.profiler.kineto_results.events()
    anchors = [e for e in events if e.name() == "bench.anchor" and e.device_type().name == "CPU"]
    assert anchors
    offset = anchors[0].start_ns() - anchor
    names = {s.name for s in ring}
    assert {"mapper.input_pointcloud", "core.update", "raycast.polar_cube", "mapper.move_to"} <= names
    ranges = {}
    for e in events:
        if e.device_type().name == "CPU" and e.name() in names:
            ranges.setdefault(e.name(), []).append(e.start_ns() - offset)
    for name in names:
        want = [s.t0_ns for s in ring if s.name == name]
        got = sorted(ranges.get(name, []))
        assert len(got) == len(want), name
        for g, w in zip(got, sorted(want)):
            assert abs(g - w) <= 100_000, (name, g - w)


def test_one_service_frame_span_tree_and_ids():
    svc = _service()
    svc.update_pose(np.zeros(3), EYE)
    svc.enqueue(_frame(3.0))
    svc.spin_once(now=1.0)   # first frame: everything warmed, every timer due
    t0 = _since()
    svc.update_pose(np.array([0.02, 0.0, 0.0]), EYE)
    assert svc.enqueue(_frame(7.25, seed=1))
    assert svc.spin_once(now=2.0) == 1
    got = tracing.spans(t0)
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == ["service.update_pose", "service.spin_once"]
    pose, spin = roots
    assert [s.name for s in _children(pose, got)] == ["mapper.move_to"]
    (move,) = _children(pose, got)
    assert [s.name for s in _children(move, got)] == ["core.move_to"]
    kids = _children(spin, got)
    assert [s.name for s in kids] == ["service.drain", "service.fuse", "service.drain"]
    drain, fuse, empty = kids
    assert drain.rid == fuse.rid == 7.25 and empty.rid == spin.rid != 7.25
    (ip,) = _children(fuse, got)
    assert ip.name == "mapper.input_pointcloud" and ip.rid == 7.25
    steps = _children(ip, got)
    assert [s.name for s in steps] == ["mapper.filter", "mapper.upload", "mapper.route", "core.update"]
    assert [s.name for s in _children(steps[-1], got)] == STAGES
    assert all(s.rid == 7.25 for s in got if s.t0_ns >= fuse.t0_ns and s.t1_ns <= fuse.t1_ns)
    # the timers and the publish run in the spin's own time
    assert spin.transfers == PER_UPDATE + PER_PUBLISH
    # Statistics reads the fuse span instead of a clock of its own
    assert svc.stats.last_update_latency == pytest.approx(fuse.ms / 1e3)
    assert svc.stats.frames_processed == 2


def test_blocking_transfers_per_frame():
    svc = _service()
    svc.update_pose(np.zeros(3), EYE)
    svc.enqueue(_frame(0.0))
    svc.spin_once(now=1.0)
    for k, now in enumerate((1.125, 1.25, 1.375, 1.5), start=1):
        before = tracing.blocking_transfers()
        t0 = _since()
        svc.update_pose(np.array([0.01 * k, 0.0, 0.0]), EYE)
        svc.enqueue(_frame(float(k), seed=k))
        svc.spin_once(now=now)
        published = k % 2 == 0    # the 5 Hz publisher, every other 10 Hz frame
        want = PER_POSE + PER_UPDATE + (PER_PUBLISH if published else 0)
        assert tracing.blocking_transfers() - before == want, k
        roots = [s for s in tracing.spans(t0) if s.parent is None]
        assert sum(s.transfers for s in roots) == want
        (ip,) = [s for s in tracing.spans(t0) if s.name == "mapper.input_pointcloud"]
        assert ip.transfers == PER_UPDATE


def test_fps_is_the_service_own_last_50_frames():
    """``pointcloud_process_fps`` is one over the mean of this service's
    last 50 pointcloud ``service.fuse`` durations, kept by the service:
    another service's frames and spans that push its own out of the ring
    move it not."""
    svc, other = _service(publish=False), _service(publish=False)
    fused = []
    for k in range(3):
        t0 = _since()
        svc.enqueue(_frame(float(k), seed=k))
        svc.spin_once(now=1.0 + k)
        fused += [s.ms / 1e3 for s in tracing.spans(t0) if s.name == "service.fuse"]
    assert svc._proc_times.maxlen == 50 and list(svc._proc_times) == fused
    fps = svc.stats.pointcloud_process_fps
    assert fps == pytest.approx(1.0 / np.mean(fused))
    other.enqueue(_frame(9.0))
    other.spin_once(now=1.0)
    for _ in range(tracing.RING_SIZE):
        with tracing.span("elsewhere"):
            pass
    assert not [s for s in tracing.spans() if s.name == "service.fuse"]
    assert svc.stats.pointcloud_process_fps == fps and svc.stats.frames_processed == 3
    svc._proc_times.extend([0.5] * 49)
    assert len(svc._proc_times) == 50
    svc.enqueue(_frame(4.0, seed=4))
    svc.spin_once(now=5.0)
    assert list(svc._proc_times)[:49] == [0.5] * 49
    assert svc.stats.pointcloud_process_fps == pytest.approx(1.0 / np.mean(svc._proc_times))


@pytest.mark.cuda
def test_card_frame_syncs_equal_blocking_transfers():
    """On the card: one service frame's synchronising calls, as torch's
    sync debug mode reports them, equal its ``blocking_transfers`` (torch
    reporting more means a copy that does not go through the counter); and
    under a profiler the update's stages carry stream times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    svc = _service("cuda")
    for k in range(3):  # builds K1 and warms every shape, timers and publisher
        svc.update_pose(np.array([0.01 * k, 0, 0]), EYE)
        svc.enqueue(_frame(float(k), seed=k))
        svc.spin_once(now=1.0 + 0.125 * k)
    torch.cuda.synchronize()
    before = tracing.blocking_transfers()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            svc.update_pose(np.array([0.04, 0, 0]), EYE)
            svc.enqueue(_frame(3.0, seed=3))
            svc.spin_once(now=1.5)      # the publisher is due
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted = tracing.blocking_transfers() - before
    syncs = [w for w in caught if str(w.message).startswith("called a synchronizing CUDA operation")]
    assert counted == PER_POSE + PER_UPDATE + PER_PUBLISH
    assert len(syncs) == counted, [str(w.message) for w in syncs]
    t0 = _since()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        svc.enqueue(_frame(4.0, seed=4))
        svc.spin_once(now=1.625)
        torch.cuda.synchronize()
    stages = [s for s in tracing.spans(t0) if s.name in STAGES]
    assert [s.name for s in stages] == STAGES
    assert all(s.stream_ms is not None and s.stream_ms >= 0 for s in stages)
    assert sum(s.stream_ms for s in stages) > 0
