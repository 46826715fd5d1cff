"""The port's examples (``elevation_mapping_cupy_torch/examples/``) against
the JAX package on the CPU.

Each test runs a port example's ``run(device="cpu", ...)`` and the JAX
package's public functions on the same inputs, as the JAX example calls
them: NumPy-seeded inputs are shared as they are; ``jax.random``'s draws go
through the port's ``*_from_draws`` halves of ``runtime/datagen.py``. Then
the port example's ``main`` prints from that run (its ``run`` patched to
return it), and the invariants ``tests/test_examples.py`` asserts of the
JAX example's output must hold of the port's.

Tolerances: elevation, variance and traversability (and the other float
layers) within 1e-4 on >= 99.9 % of cells, NaN where JAX has NaN; packed
colours bit for bit; plane labels and region counts equal, plane normals
within 3e-5 of JAX and supports within 1e-5 (ROADMAP's accepted plane-fit
difference); polygon ``is_safe`` equal and its mean within 1e-5.

Batched datagen runs at B = 4 maps and 2 steps instead of the example's
32 and 5 (the JAX batch at 32 would not be sharded here either). The
sharded world is in ``tests/test_torch_examples_sharded.py``.
"""

import importlib
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch import examples
from elevation_mapping_cupy_torch.examples import (
    batched_datagen,
    minimal_mapping,
    plane_decomposition_demo,
    robot_stack,
    semantic_mapping,
)
from elevation_mapping_cupy_torch.runtime import datagen as td

from .test_torch_datagen import _jax_batch_draws, _jax_cloud_draws, _jax_terrain_lattices

REPO = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-4
MIN_SHARE = 0.999


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _jax_example(name):
    """The JAX package's example module (its inputs and helpers)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(tag, got, want, packed=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    if packed:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=tag)
        return
    both_nan = np.isnan(got) & np.isnan(want)
    close = both_nan | (np.abs(np.nan_to_num(got, nan=1e9) - np.nan_to_num(want, nan=1e9)) <= ATOL)
    assert close.mean() >= MIN_SHARE, f"{tag}: {close.mean():.5f} of cells within {ATOL}"


def _same_terrain(got, want):
    """Plane decompositions: labels and regions equal, normals within 3e-5,
    supports within 1e-5."""
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got.regions) == len(want.regions)
    for a, b in zip(got.regions, want.regions):
        assert a.label == b.label
        np.testing.assert_allclose(np.asarray(a.normal), np.asarray(b.normal), atol=3e-5)
        np.testing.assert_allclose(np.asarray(a.support), np.asarray(b.support), atol=1e-5)


def _printed(monkeypatch, capsys, module, result, argv=("--device", "cpu")):
    """What the port example's main prints for ``result``."""
    monkeypatch.setattr(module, "run", lambda *a, **k: result)
    assert module.main(list(argv)) == 0
    return capsys.readouterr().out


# ---------------------------------------------------------------------------


def test_plane_decomposition_demo_matches_jax(tmp_path, monkeypatch, capsys):
    from elevation_mapping_cupy_tpu.planeseg.pipeline import PlaneDecompositionPipeline

    out = str(tmp_path / "overlay.png")
    r = plane_decomposition_demo.run(device="cpu", out=out, repeats=1)
    jpipe = PlaneDecompositionPipeline(resolution=plane_decomposition_demo.RESOLUTION)
    want = jpipe.update(plane_decomposition_demo.make_terrain())
    _same_terrain(r["terrain"], want)
    for q, poly in zip(plane_decomposition_demo.QUERIES, r["polygons"]):
        jpoly = jpipe.convex_approximation(want, q, n_vertices=12)
        assert (poly is None) == (jpoly is None)
        if poly is not None:
            np.testing.assert_allclose(poly, jpoly, atol=1e-5)
    assert r["overlay"] == out and os.path.exists(out)

    text = _printed(monkeypatch, capsys, plane_decomposition_demo, r)
    m = re.search(r"regions: (\d+)", text)
    assert m and int(m.group(1)) >= 2
    assert text.count("convex 12-gon") >= 1
    assert "overlay written: " + out in text and "stage" in text


def test_plane_decomposition_overlay_defaults_to_a_temporary_directory():
    """Without --out the overlay never lands on the tracked
    examples/decomposition_overlay.png."""
    tracked = os.path.join(REPO, "examples", "decomposition_overlay.png")
    before = open(tracked, "rb").read()
    r = plane_decomposition_demo.run(device="cpu", repeats=0)
    assert os.path.exists(r["overlay"])
    assert os.path.realpath(os.path.dirname(r["overlay"])) != os.path.realpath(os.path.dirname(tracked))
    assert open(tracked, "rb").read() == before


def test_minimal_mapping_matches_jax(monkeypatch, capsys):
    import jax
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu import MapConfig
    from elevation_mapping_cupy_tpu.mapper import ElevationMap
    from elevation_mapping_cupy_tpu.planeseg.pipeline import PlaneDecompositionPipeline
    from elevation_mapping_cupy_tpu.runtime.datagen import procedural_terrain, simulate_depth_cloud

    c = minimal_mapping.CONFIG
    cfg = MapConfig(resolution=c.resolution, map_length=c.map_length, max_ray_length=c.max_ray_length,
                    max_points=c.max_points)
    em = ElevationMap(cfg)
    eye = np.eye(3, dtype=np.float32)
    terrain = procedural_terrain(jax.random.PRNGKey(3), cfg.cell_n, cfg.resolution)
    cloud_draws = []
    for step in range(minimal_mapping.STEPS):
        pos = minimal_mapping.robot_position(step)
        key = jax.random.PRNGKey(10 + step)
        cloud, t = simulate_depth_cloud(key, terrain, cfg.resolution,
                                        jnp.asarray(pos + np.array([0, 0, 0.7], np.float32)), minimal_mapping.POINTS)
        cloud_draws.append(_jax_cloud_draws(jax, key, minimal_mapping.POINTS))
        em.input_pointcloud(np.asarray(cloud), ["x", "y", "z"], eye, np.asarray(t), 0.0, 0.0)
        em.move_to(pos, eye)
        em.update_normal()
    want = {}
    for layer in minimal_mapping.LAYERS:
        want[layer] = np.zeros((em.cell_n - 2, em.cell_n - 2), np.float32)
        em.get_map_with_name_ref(layer, want[layer])
    result = np.zeros(3)
    em.get_polygon_traversability(minimal_mapping.POLYGON, result)
    planes = PlaneDecompositionPipeline(cfg.resolution).update(want["elevation"])

    draws = (_jax_terrain_lattices(jax, jax.random.PRNGKey(3), cfg.cell_n), cloud_draws)
    r = minimal_mapping.run(device="cpu", draws=draws)
    for layer in minimal_mapping.LAYERS:
        _close(layer, r["layers"][layer], want[layer])
    assert bool(r["polygon"][0]) == bool(result[0])
    assert abs(r["polygon"][1] - result[1]) <= 1e-5
    _same_terrain(r["planes"], planes)

    text = _printed(monkeypatch, capsys, minimal_mapping, r)
    for layer in minimal_mapping.LAYERS:
        assert re.search(rf"^{layer}\s+valid=\s*\d+ range=\[", text, re.M)
    assert f"polygon safety: is_safe={bool(result[0])}" in text
    assert f"plane decomposition: {len(planes.regions)} planar regions" in text


def test_minimal_mapping_default_draws_are_seeded():
    a, b = minimal_mapping.make_draws("cpu"), minimal_mapping.make_draws("cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert len(a[1]) == minimal_mapping.STEPS
    assert all(torch.equal(x, y) for da, db in zip(a[1], b[1]) for x, y in zip(da, db))
    assert not torch.equal(a[1][0].noise, a[1][1].noise)


def test_semantic_mapping_matches_jax(monkeypatch, capsys):
    import warnings

    from elevation_mapping_cupy_tpu import MapConfig
    from elevation_mapping_cupy_tpu.mapper import ElevationMap
    from elevation_mapping_cupy_tpu.sensor.pointcloud import PointcloudParameter, PointcloudSensorNode

    c = semantic_mapping.CONFIG
    em = ElevationMap(MapConfig(resolution=c.resolution, map_length=c.map_length, max_ray_length=c.max_ray_length,
                                pointcloud_channel_fusions=c.pointcloud_channel_fusions,
                                image_channel_fusions=c.image_channel_fusions))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        node = PointcloudSensorNode(PointcloudParameter(channels=("grass", "obstacle")),
                                    semantic_model="random_features")
    depth, rgb = semantic_mapping.synth_frame()
    cloud, channels = node(depth, semantic_mapping.K, rgb=rgb)
    em.input_pointcloud(cloud, channels, semantic_mapping.CAM_R, semantic_mapping.MAST, 0.0, 0.0)
    em.input_image([rgb[1].astype(np.float32) / 255.0], ["grass"], semantic_mapping.CAM_R, semantic_mapping.MAST,
                   semantic_mapping.K, np.zeros(5, np.float32))
    r = semantic_mapping.run(device="cpu")
    assert r["cloud_shape"] == cloud.shape and r["channels"] == channels
    for layer in semantic_mapping.LAYERS:
        want = np.zeros((em.cell_n - 2, em.cell_n - 2), np.float32)
        em.get_map_with_name_ref(layer, want)
        _close(layer, r["layers"][layer], want, packed=layer == "rgb")

    text = _printed(monkeypatch, capsys, semantic_mapping, r)
    assert "green-dominant world: True" in text
    for layer in ("elevation", "rgb", "grass", "obstacle"):
        assert f"layer {layer}" in text


def test_batched_datagen_matches_jax(monkeypatch, capsys):
    """B = 4 maps and 2 steps (the example ships 32 and 5)."""
    import jax
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu import MapConfig
    from elevation_mapping_cupy_tpu.nn.traversability import default_weights
    from elevation_mapping_cupy_tpu.parallel import batched_update, init_batch
    from elevation_mapping_cupy_tpu.runtime.datagen import make_batch_clouds

    B, n, steps = 4, 20_000, 2
    c = batched_datagen.config(n)
    cfg = MapConfig(resolution=c.resolution, map_length=c.map_length, max_ray_length=c.max_ray_length, max_points=n)
    states, w = init_batch(cfg, B), default_weights()
    key = jax.random.PRNGKey(0)
    zeros, Rs, mask = jnp.zeros((B,)), jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.ones((B, n), bool)
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        pts, t, _ = make_batch_clouds(sub, B, cfg.cell_n, cfg.resolution, n)
        draws.append(_jax_batch_draws(jax, sub, B, cfg.cell_n, n))
        states = batched_update(states, pts, mask, Rs, t, zeros, zeros, w, cfg)
    r = batched_datagen.run(device="cpu", batch=B, points=n, steps=steps, draws=draws)
    got, want = r["states"].layers.numpy(), np.asarray(states.layers)
    for i, name in enumerate(("elevation", "variance", "is_valid", "traversability")):
        for b in range(B):
            _close(f"map {b} {name}", got[b, i], want[b, i])
    assert float(want[:, 2].mean()) > 0.1

    text = _printed(monkeypatch, capsys, batched_datagen, r, ["--device", "cpu", "--batch", str(B), "--points",
                                                              str(n), "--steps", str(steps)])
    assert f"devices=1  envs={B}  cells={cfg.cell_n}^2  pts/env={n}" in text
    assert len(re.findall(r"^step \d: .* ms  \(.* maps/s\)$", text, re.M)) == steps
    assert re.search(r"^steady-state: [0-9.]+ maps/s$", text, re.M)


def test_batched_datagen_default_draws_are_make_batch_clouds():
    """The example's default draws give make_batch_clouds' clouds from the
    same seed."""
    cfg = batched_datagen.config(500)
    gen = td.make_generator(0, "cpu")
    want = [td.make_batch_clouds(gen, 2, cfg.cell_n, cfg.resolution, 500)[:2] for _ in range(2)]
    gen = td.make_generator(0, "cpu")
    got = [td.batch_clouds_from_draws(td.draw_batch_clouds(gen, 2, cfg.cell_n, 500), cfg.cell_n, cfg.resolution)[:2]
           for _ in range(2)]
    assert all(torch.equal(a, b) for g, w_ in zip(got, want) for a, b in zip(g, w_))
    r = batched_datagen.run(device="cpu", batch=2, points=500, steps=2)
    assert r["states"].layers.shape == (2, 7, cfg.cell_n, cfg.cell_n) and r["maps_per_s"] > 0


def test_robot_stack_settings_equal_the_yaml(tmp_path):
    """The literal the card's machine (no PyYAML) runs with is what the
    example's YAML loads to, and that YAML is the JAX example's."""
    from elevation_mapping_cupy_torch.config import load_config_with_extras

    path = tmp_path / "robot_stack.yaml"
    path.write_text(robot_stack.CONFIG)
    assert load_config_with_extras(str(path)) == robot_stack.settings()
    assert robot_stack.CONFIG == _jax_example("robot_stack").CONFIG


def test_robot_stack_matches_jax(tmp_path, monkeypatch, capsys):
    from elevation_mapping_cupy_tpu.planeseg.pipeline import PlaneDecompositionPipeline
    from elevation_mapping_cupy_tpu.runtime.service import MappingService

    jx = _jax_example("robot_stack")
    rng = np.random.default_rng(0)
    path = tmp_path / "robot_stack.yaml"
    path.write_text(jx.CONFIG)
    svc = MappingService.from_config(str(path))
    published = {}
    svc.set_publisher_callback("elevation_map_raw", published.update)
    svc.enable_raw_ingest(capacity=8, slab_bytes=2 << 20)
    for i in range(robot_stack.TICKS):
        raw, n_pts = jx.lidar_frame_raw(rng)
        svc.enqueue_raw_pointcloud(raw, n_pts, 16, [0, 4, 8, 12], [], robot_stack.LIDAR_R, robot_stack.LIDAR_T,
                                   stamp=0.2 * i, subscriber="front_lidar")
        if i % 3 == 0:
            svc.enqueue(jx.camera_frame(), subscriber="color_cam")
        svc.spin_once(now=0.2 * (i + 1))
    want = svc.mapper.get_layers(list(robot_stack.MAP_LAYERS))

    r = robot_stack.run(device="cpu")
    for layer in robot_stack.MAP_LAYERS:
        _close(layer, r["layers"][layer], want[layer], packed=layer == "rgb")
    assert sorted(r["published"]) == sorted(published)
    for layer in published:
        _close(f"published {layer}", r["published"][layer], published[layer], packed=layer == "rgb")
    assert r["dropped"] == svc.stats.frames_dropped == 0
    assert r["ring"] == svc._ring.stats()
    th = np.pi / 4
    Rf = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float64)
    _close("submap", r["submap"], svc.get_submap(np.zeros(2), (1.5, 1.5), ["elevation"],
                                                 frame_transform=(Rf, np.zeros(3)))["elevation"])
    for name, poly in (("flat ground", robot_stack.FLAT_POLY), ("platform edge", robot_stack.EDGE_POLY)):
        is_safe, untrav, _ = svc.check_safety([poly])[0]
        assert r["safety"][name][0] == is_safe and abs(r["safety"][name][1] - untrav) <= 1e-5
    assert abs(r["drift"] - svc.map_to_odom_error()) <= 1e-5
    _same_terrain(r["terrain"], PlaneDecompositionPipeline(resolution=svc.mapper.resolution).update(
        published["elevation"]))
    assert r["foothold"] is not None and len(r["spin_s"]) == robot_stack.TICKS

    text = _printed(monkeypatch, capsys, robot_stack, r)
    assert "sensors=['color_cam', 'front_lidar']" in text
    assert "dropped: 0" in text
    assert "planar regions: 2" in text or "planar regions: 3" in text
    assert "check_safety[platform edge]: safe=False" in text
    assert "foothold polygon: convex" in text


@pytest.mark.parametrize("name", examples.EXAMPLES)
def test_examples_default_to_the_card(name):
    """Without --device each example runs on the card; without one it
    raises and names --device cpu (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    module = importlib.import_module(f"elevation_mapping_cupy_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])
