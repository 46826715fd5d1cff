"""The cell datagen_mem.b64_ep8_cam: its configuration against the port's,
its traffic against b64_ep8's, the plain reference of the image path
(``reference/image.py``) against the program, a shrunk window judged as a
run judges it, the faults of the image path and the control failing it,
and the new per-layer metrics on synthetic records."""

import collections
import copy
import dataclasses
import os
import time

import pytest
import torch

from benchmark import harness as H
from benchmark import run as RUN
from benchmark.reference import image as I
from benchmark.reference import update as U
from benchmark.reference.params import Params
from benchmark.traffic import camera_images, terrain_clouds

CELL = "datagen_mem.b64_ep8_cam"
MAN = H.manifest()
DRIVER = H.load_driver("batched_steps_image")


def _shrunk():
    """The cell at the tests' size: a 52x52 map, 4096 points a map, 2 maps,
    episodes of 3 steps, 64x48 images through the cell's field of view. On
    a smaller map no walk passes ``WALK_CUT`` steps, and the cut walk could
    not be told from the whole one."""
    cell = H.workload(MAN, CELL)
    cfg = copy.deepcopy(H.config_file(MAN, cell["config"]))
    tr = copy.deepcopy(H.traffic_file(cell["traffic"]))
    cfg["map_config"]["map_length"] = 2.0
    tr.update(points=4096, maps=2, pool_episodes=1, episode_steps=3)
    tr["camera"].update(width=64, height=48, fx=46.2, fy=46.2, cx=32.0, cy=24.0)
    return cfg, tr


def _context(seed, cfg, tr, seconds=1.0):
    return RUN.context(CELL, seed, seconds, False, "cpu", time.perf_counter(), MAN, cfg, tr)


def test_datagen_mem_is_the_default_config_with_mem_layers_and_the_walk():
    from elevation_mapping_cupy_torch import MapConfig

    body = H.config_file(MAN, "datagen_mem")
    want = MapConfig(max_points=100000, semantic_layers=("rgb", "grass", "tree", "person"),
                     image_occlusion_mode="bresenham")
    assert MapConfig(**H.map_config_fields(body)) == want
    assert dataclasses.asdict(MapConfig(**H.map_config_fields(body))) == dataclasses.asdict(want)
    default = H.config_file(MAN, "datagen_default")
    changed = {k for k in body["map_config"] if body["map_config"][k] != default["map_config"][k]}
    assert changed == {"semantic_layers", "image_occlusion_mode"} and set(body["map_config"]) == set(default["map_config"])
    assert body["map_config"]["image_channel_fusions"] == [["rgb", "color"], ["default", "exponential"]]
    assert body["weights"] == {"zeros": True} and body["reduced"] == []
    assert set(default["assumed"]) | {"camera", "image", "image_content"} <= set(body["assumed"])


def test_traffic_is_b64_ep8_with_a_camera_and_higher_terraces():
    mine, base = H.traffic_file("b64_ep8_cam"), H.traffic_file("b64_ep8")
    assert mine["driver"] == "batched_steps_image"
    strip = lambda d: {k: v for k, v in d.items() if k not in ("driver", "limits", "about", "terrain")}  # noqa: E731
    assert strip(mine) == dict(strip(base), channels=mine["channels"], camera=mine["camera"])
    assert dict(mine["terrain"], step_height=base["terrain"]["step_height"]) == base["terrain"]
    assert mine["channels"] == ["rgb", "grass", "tree", "person"]
    assert camera_images.planes(mine["channels"]) == 6
    assert set(mine["limits"]) == {"final_mismatch", "semantic_mismatch"}


def test_the_camera_looks_ahead_and_down():
    rot = camera_images.camera_rotation(30.0, "cpu")
    assert torch.allclose(rot @ rot.T, torch.eye(3), atol=1e-6) and float(torch.det(rot)) == pytest.approx(1.0)
    forward = rot[2]  # the optical axis in the world
    assert forward[0] > 0 and float(forward[2]) == pytest.approx(-0.5, abs=1e-6)


def _mapped(seed=5, steps=2):
    """(program states, reference state, cfg, p, episode, cameras) after the
    cell's first ``steps`` geometric steps on its shrunk traffic."""
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.parallel import batched_move_to, batched_update, init_batch

    cfg_d, tr = _shrunk()
    cfg, p = MapConfig(**H.map_config_fields(cfg_d)), Params(cfg_d["map_config"])
    ep = terrain_clouds.make_pool(seed, tr, cfg.cell_n, cfg.resolution, "cpu")[0]
    cams = camera_images.make_cameras(torch.Generator().manual_seed(seed), tr, ep.sensor)
    b, n = tr["maps"], tr["points"]
    eye, mask, zero = torch.eye(3).expand(b, 3, 3), torch.ones((b, n), dtype=torch.bool), torch.zeros(b)
    states = init_batch(cfg, b, "cpu")
    for s in range(steps):
        states = batched_move_to(states, ep.base[s], eye, cfg)
        states = batched_update(states, ep.clouds[s], mask, eye, ep.sensor[s], zero, zero,
                                TravFilter(**H.weight_arrays(cfg_d)), cfg)
    ref = U.State(states.layers, states.normal, states.center, states.mean_error, states.additive_mean_error)
    return states, ref, cfg, p, cams, tr


def test_the_program_bresenham_image_step_equals_the_reference():
    """From one mapped state, one batched Bresenham image step: the
    program's visible cells and every semantic layer equal the reference's
    bit for bit on the CPU, where both take the same roots and quotients."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.parallel import batched_input_image

    states, ref, cfg, p, cams, tr = _mapped()
    channels = tuple(tr["channels"])
    h, w = tr["camera"]["height"], tr["camera"]["width"]
    args = (cams.R[1], cams.t[1], cams.K, cams.D)
    _, valid = core.image_correspondence(states, h, w, *args, cfg)
    u, v, visible = I.correspondence(ref, *args, h, w, p)
    assert torch.equal(valid, visible)
    seen = (u != 0) | (v != 0)
    assert float(seen.float().mean()) > 0.03 and int((seen & ~visible).sum()) > 10  # the walk has work
    got = batched_input_image(states, cams.images[1], *args, cfg, channels).semantic
    want = I.input_image(ref, torch.zeros_like(got), cams.images[1], *args, channels, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert I.semantic_mismatch(got, want, p) == ({name: 0.0 for name in channels}, 0.0)


def test_the_reference_walk_takes_every_step_and_reads_nothing_back(monkeypatch):
    """The reference's walk runs all 2·cell_n steps with no read-back: it
    never turns a device tensor into a Python value."""
    states, ref, cfg, p, cams, tr = _mapped(steps=1)
    calls = collections.Counter()
    real_where = torch.where

    def counting_where(*a, **kw):
        calls["where"] += 1
        return real_where(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("read back")

    monkeypatch.setattr(torch, "where", counting_where)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    I.correspondence(ref, cams.R[0], cams.t[0], cams.K, cams.D, tr["camera"]["height"], tr["camera"]["width"], p)
    assert calls["where"] >= 2 * p.cell_n * 6  # six per step of the walk


def test_a_shrunk_window_agrees_and_records_the_image_spans():
    from elevation_mapping_cupy_torch import tracing

    cfg, tr = _shrunk()
    since = time.perf_counter_ns()
    correct, rec, metrics, checks, _ = RUN.execute(_context(2**31 + 7, cfg, tr))
    assert correct and checks["final_mismatch"]["value"] == 0.0 and checks["semantic_mismatch"]["value"] == 0.0
    assert rec["attempted"] == rec["steps"] * 2 > 0 and rec["failed"] == 0
    assert set(metrics) == {"maps_per_s", "setup_s"}
    steps = [s for s in tracing.spans(since) if s.name == "batch.input_image"]
    assert len(steps) >= rec["steps"] and all(s.attrs == {"maps": 2} and s.transfers >= 1 for s in steps)
    assert float(rec["finals"][max(rec["finals"])]["semantic"][:, 1].abs().max()) > 0  # the layers were fused


@pytest.mark.parametrize("kind", DRIVER.FAULTS)
def test_each_fault_of_the_image_path_fails_the_limits(kind):
    cfg, tr = _shrunk()
    with DRIVER.fault(kind):
        correct, _, _, checks, _ = RUN.execute(_context(2**31 + 11, cfg, tr))
    assert not correct, checks
    assert checks["semantic_mismatch"]["value"] > checks["semantic_mismatch"]["limit"], checks


def test_a_fault_is_taken_out_again():
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.ops import image as img_ops

    real = (core.input_image, img_ops._occlusion_bresenham)
    for kind in DRIVER.FAULTS:
        with DRIVER.fault(kind):
            pass
        assert (core.input_image, img_ops._occlusion_bresenham) == real and not hasattr(img_ops, "range")
    with pytest.raises(ValueError):
        with DRIVER.fault("unknown"):
            pass


def test_the_control_fails_the_limits():
    from benchmark import image_control

    cfg, tr = _shrunk()
    res = image_control.readings(CELL, 2**31 + 3, 1.0, "cpu", config=cfg, traffic=tr, faults=("walk_cut",))
    limits = tr["limits"]
    assert all(v <= limits[k] for k, v in res["reference"].items()), res
    assert all(v > limits[k] for k, v in res["control_bf16"].items()), res
    assert not res["fault_walk_cut"]["correct"]


def test_the_import_scan_reaches_the_image_path():
    from benchmark.tests import test_benchmark_imports as IMP
    rel = {p.replace(os.sep, "/") for p in (os.path.relpath(f, H.BENCH_DIR) for f in IMP._files())}
    for sub in ("reference/image.py", "traffic/camera_images.py", "drivers/batched_steps_image.py",
                "image_control.py"):
        assert sub in rel
    for path in IMP._files("reference"):
        assert not IMP._top(IMP._imports(path), IMP.JAX + ("elevation_mapping_cupy_torch",)), path


tracing = pytest.importorskip("elevation_mapping_cupy_torch.tracing")


def _span(sid, name, t0, ms, stream=None, transfers=0, **attrs):
    s = tracing.span(name, **attrs)
    s.sid, s.rid, s.thread, s.parent = sid, 0, 1, None
    s.t0_ns = int(round(t0 * 1e9))
    s.t1_ns = s.t0_ns + int(round(ms * 1e6))
    s._stream_ms = stream
    s.transfers = transfers
    return s


def test_the_image_span_metrics(monkeypatch):
    rec = {"window_start": 100.0, "window_end": 115.5, "trace": {"window": (110.0, 115.0)}, "maps": 64}
    items = []
    for i, t in enumerate((101.0, 102.0, 103.0, 111.0, 112.0)):
        items += [_span(10 * i + 1, "batch.update", t, 20.0, maps=64),
                  _span(10 * i + 2, "batch.input_image", t + 0.03, 50.0 + i, 40.0 + i, 6 + i % 2, maps=64)]
    monkeypatch.setattr(tracing, "_ring", collections.deque(items, maxlen=tracing.RING_SIZE))
    assert H.load_metric("image_stream_ms_per_map.datagen_mem").read(rec) == pytest.approx((43.0 + 44.0) / 128)
    assert H.load_metric("image_issue_ms_per_step.datagen_mem").read(rec) == pytest.approx(51.0)
    assert H.load_metric("image_blocking_transfers_per_step.datagen_mem").read(rec) == pytest.approx(19 / 3)
    # a program without the span gives None
    monkeypatch.setattr(tracing, "_ring", collections.deque(items[::2], maxlen=tracing.RING_SIZE))
    for name in ("image_stream_ms_per_map", "image_issue_ms_per_step", "image_blocking_transfers_per_step"):
        assert H.load_metric(name + ".datagen_mem").read(rec) is None
