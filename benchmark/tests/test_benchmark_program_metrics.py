"""The per-layer metrics that read the program's own spans, fed a synthetic
record and span ring: known spans give known values, an empty ring (or a
program without one) gives None, and a shrunk traced run of the robot's
cell on the CPU reads every one of its host metrics."""

import collections
import math

import pytest

from benchmark import harness as H
from benchmark import program_spans as P
from benchmark import run as RUN

tracing = pytest.importorskip("elevation_mapping_cupy_torch.tracing")

ROBOT = ["service_drain_ms.robot", "mapper_prep_ms.robot", "update_issue_ms.robot", "polar_issue_ms.robot",
         "blocking_transfers_per_frame.robot"]
DATAGEN = ["polar_stream_ms_per_map.datagen"]
# window: untraced [100, 110), traced [110, 115)
WINDOW = {"window_start": 100.0, "window_end": 115.5, "trace": {"window": (110.0, 115.0)}}


class _Ring:
    """Builds synthetic spans: ``add`` takes start and length in seconds
    and ms and returns the span, its parent given by the one passed."""

    def __init__(self):
        self.items = []
        self.sid = 0

    def add(self, name, t0, ms, parent=None, transfers=0, stream=None, **attrs):
        s = tracing.span(name, **attrs)
        self.sid += 1
        s.sid, s.rid, s.thread = self.sid, 0, 1
        s.parent = None if parent is None else parent.sid
        s.t0_ns = int(round(t0 * 1e9))
        s.t1_ns = s.t0_ns + int(round(ms * 1e6))
        s.transfers = transfers
        s._stream_ms = stream
        self.items.append(s)
        return s


@pytest.fixture
def ring(monkeypatch):
    r = _Ring()
    monkeypatch.setattr(tracing, "_ring", collections.deque(r.items, maxlen=tracing.RING_SIZE))

    def install():
        monkeypatch.setattr(tracing, "_ring", collections.deque(r.items, maxlen=tracing.RING_SIZE))

    r.install = install
    return r


def _frame(r, t, drain_ms, prep, update_ms, polar, publish):
    """One robot frame as the service traces it: a pose, then a spin that
    drains and fuses one frame, runs the timers and maybe publishes (the
    publish's read-back counted in the spin's own transfers)."""
    r.add("service.update_pose", t, 0.5, transfers=2)
    spin = r.add("service.spin_once", t + 0.001, 60.0, transfers=6 + publish)
    r.add("service.drain", t + 0.001, drain_ms - 0.1, spin)
    fuse = r.add("service.fuse", t + 0.002, 50.0, spin)
    r.add("service.drain", t + 0.053, 0.1, spin)
    ip = r.add("mapper.input_pointcloud", t + 0.002, 49.0, fuse)
    r.add("mapper.filter", t + 0.0021, prep[0], ip)
    r.add("mapper.upload", t + 0.004, prep[1], ip)
    r.add("mapper.route", t + 0.006, 0.01, ip)
    up = r.add("core.update", t + 0.007, update_ms, ip)
    r.add("raycast.polar_cube", t + 0.010, polar[0], up, stream=0.2)
    r.add("raycast.polar_evaluate", t + 0.015, polar[1], up, stream=0.3)


def _robot_ring(r):
    # four untraced frames, two of them publishing; one traced frame whose
    # host times, inflated by the profiler, are not read
    _frame(r, 101.0, 1.2, (2.0, 1.0), 35.0, (3.0, 2.0), True)
    _frame(r, 102.0, 1.0, (2.5, 1.0), 36.0, (3.0, 2.5), False)
    _frame(r, 103.0, 1.4, (1.5, 1.0), 34.0, (2.0, 2.0), True)
    _frame(r, 104.0, 1.1, (2.0, 2.0), 37.0, (4.0, 2.0), False)
    _frame(r, 111.0, 9.0, (9.0, 9.0), 90.0, (9.0, 9.0), True)
    r.install()


def test_robot_metrics_read_known_spans(ring):
    _robot_ring(ring)
    got = {m: H.load_metric(m).read(WINDOW) for m in ROBOT}
    assert got["service_drain_ms.robot"] == pytest.approx(1.15)       # median of 1.2, 1.0, 1.4, 1.1
    assert got["mapper_prep_ms.robot"] == pytest.approx(3.25)         # median of 3, 3.5, 2.5, 4
    assert got["update_issue_ms.robot"] == pytest.approx(35.5)
    assert got["polar_issue_ms.robot"] == pytest.approx(5.25)         # median of 5, 5.5, 4, 6
    assert got["blocking_transfers_per_frame.robot"] == pytest.approx((4 * 8 + 2) / 4)


def test_a_spin_with_two_frames_counts_its_drains_per_frame(ring):
    spin = ring.add("service.spin_once", 101.0, 100.0)
    for k in range(2):
        ring.add("service.drain", 101.0 + 0.01 * k, 1.5, spin)
        ring.add("service.fuse", 101.005 + 0.01 * k, 40.0, spin)
    ring.add("service.drain", 101.05, 0.2, spin)
    ring.add("service.spin_once", 102.0, 0.3)       # fused nothing: not read
    ring.install()
    assert H.load_metric("service_drain_ms.robot").read(WINDOW) == pytest.approx(1.6)


def test_an_untraced_record_reads_the_whole_window(ring):
    _robot_ring(ring)
    rec = dict(WINDOW, trace=None)
    assert H.load_metric("update_issue_ms.robot").read(rec) == pytest.approx(36.0)   # 35, 36, 34, 37, 90
    assert P.traced(rec) is None and P.untraced(rec) == (100.0, 115.5)


def _step(r, t, maps, streams, polar=True):
    step = r.add("batch.update", t, 20.0, maps=maps)
    r.add("core.associate", t + 0.001, 1.0, step, stream=0.5)
    if polar:
        r.add("raycast.polar_cube", t + 0.002, 2.0, step, stream=streams[0])
        r.add("raycast.polar_evaluate", t + 0.004, 3.0, step, stream=streams[1])


def test_polar_stream_time_per_map_reads_the_traced_steps(ring):
    _step(ring, 105.0, 64, (None, None))             # untraced: no events
    _step(ring, 110.5, 64, (20.0, 44.0))
    _step(ring, 111.0, 64, (21.0, 43.0))
    _step(ring, 111.5, 64, (30.0, None))             # an event the stream had not reached: left out
    _step(ring, 112.0, 64, (0.0, 0.0), polar=False)  # no polar cleanup in it: left out
    ring.install()
    rec = dict(WINDOW, maps=64)
    assert H.load_metric("polar_stream_ms_per_map.datagen").read(rec) == pytest.approx(128.0 / 128)
    assert H.load_metric("polar_stream_ms_per_map.datagen").read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", ROBOT + DATAGEN)
def test_an_empty_ring_gives_none(ring, name):
    assert H.load_metric(name).read(dict(WINDOW, maps=8)) is None


@pytest.mark.parametrize("name", ROBOT + DATAGEN)
def test_a_program_without_the_ring_gives_none(monkeypatch, name):
    monkeypatch.setattr(P, "ring", lambda: None)
    assert H.load_metric(name).read(dict(WINDOW, maps=8)) is None


@pytest.mark.parametrize("name", ROBOT + DATAGEN)
def test_each_metric_has_its_manifest_entry(name):
    man = H.manifest()
    entry = [m for m in man["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] in ("program_span", "program_counter")
    assert entry[0]["workloads"]
    reporting = {e["name"]: e.get("workloads") for e in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for cell in entry[0]["workloads"]:
        assert cell in cells, cell
        assert reporting[entry[0]["moves"]] is None or cell in reporting[entry[0]["moves"]], cell


def test_a_shrunk_traced_robot_run_reads_its_host_metrics():
    from benchmark.tests.small import context

    ctx = context("anymal_deployed.lidar_10hz", 2**32 + 11, seconds=2.0, trace=True)
    correct, rec, metrics, checks, _ = RUN.execute(ctx)
    assert correct
    for name in ROBOT:
        assert name in metrics and math.isfinite(metrics[name][0]) and metrics[name][0] > 0, name
    # the frame's documented transfers: 6 an update, 2 a pose, 1 a publish
    assert 6 <= metrics["blocking_transfers_per_frame.robot"][0] <= 9
