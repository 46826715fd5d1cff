"""The PyTorch port as a whole: mapper, core steps, checkpoints, packaging.

The port's ``ElevationMap(device="cpu")`` and the JAX ``ElevationMap`` take
the same seeded trajectory and are compared through ``get_layers``; the
maintenance steps are compared state for state; checkpoints cross between
the packages in both directions. The port must import nothing of JAX.
"""

import ast
import dataclasses
import filecmp
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import core as jcore
from elevation_mapping_cupy_tpu import load_config as jload_config
from elevation_mapping_cupy_tpu.mapper import ElevationMap as JaxMap
from elevation_mapping_cupy_tpu.state import MapState as JaxState

import elevation_mapping_cupy_torch
from elevation_mapping_cupy_torch import MapConfig, core, load_config
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.ops import cuda_scatter
from elevation_mapping_cupy_torch.state import state_from_numpy, state_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(elevation_mapping_cupy_torch.__file__))
CFG_KW = dict(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=8192, raycast_mode="polar")
LAYERS = ["elevation", "variance", "is_valid", "traversability", "time",
          "upper_bound", "is_upper_bound", "normal_x", "normal_y", "normal_z"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _jax_state(arrays: dict) -> JaxState:
    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _assert_states_close(t_state, j_state, atol):
    got = state_to_numpy(t_state)
    for name in JaxState._fields:
        want = np.asarray(getattr(j_state, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_allclose(got[name], want, atol=atol, err_msg=name)


def test_trajectory_matches_jax_mapper():
    """Three frames of the smoke scene with move_to recentering between them
    (the robot crosses whole cells) and one frame that opens the drift gate.
    Every exported layer within 1e-4 of the JAX mapper (the polar tolerance
    of tests/test_torch_ops.py)."""
    rng = np.random.default_rng(11)
    jem = JaxMap(JaxConfig(**CFG_KW))
    tem = ElevationMap(MapConfig(**CFG_KW), device="cpu")
    for k in range(3):
        R, t, pos = torch_scenes.robot_pose(4 * k)
        pts = torch_scenes.scene_cloud(rng, 6000, R, t, r_max=2.5)
        pts[::97] = np.nan  # the mapper drops NaN rows
        noise = 0.2 if k == 1 else 0.0  # above position_noise_thresh
        for em in (jem, tem):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, noise, 0.0)
        np.testing.assert_allclose(tem.center, np.asarray(jem.center), atol=1e-6)
    assert tem.center[0] == pytest.approx(0.2)  # recentred by whole cells
    want = jem.get_layers(LAYERS)
    got = tem.get_layers(LAYERS)
    assert np.nanmean(want["is_valid"]) > 0.3
    for name in LAYERS:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    assert jem.get_additive_mean_error() != 0.0  # the drift gate did open
    assert tem.get_additive_mean_error() == pytest.approx(jem.get_additive_mean_error(), abs=1e-6)
    buf = np.zeros((40, 40), np.float32)
    tem.get_map_with_name_ref("elevation", buf)
    np.testing.assert_array_equal(buf, got["elevation"])


def test_update_routes_three_scatters(monkeypatch):
    """One geometric update reaches the K1 wrapper three times (error
    counting, fusion, the polar cube); on the CPU it runs the plain version
    and counts no kernel launch."""
    calls = []
    real = cuda_scatter.scatter_add_streams

    def counting(idx, mask, values, n_cells):
        calls.append((values.shape[1], n_cells))
        return real(idx, mask, values, n_cells)

    monkeypatch.setattr(cuda_scatter, "scatter_add_streams", counting)
    cfg = MapConfig(**CFG_KW)
    tem = ElevationMap(cfg, device="cpu")
    before = cuda_scatter.KERNEL.launches
    R, t, _ = torch_scenes.robot_pose(0)
    tem.input_pointcloud(torch_scenes.scene_cloud(np.random.default_rng(0), 3000, R, t, 2.5), ["x", "y", "z"], R, t, 0, 0)
    cube = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    assert calls == [(2, cfg.cell_n**2), (4, cfg.cell_n**2), (2, cube)]
    assert cuda_scatter.KERNEL.launches == before


def test_maintenance_steps_match_jax():
    rng = np.random.default_rng(5)
    jcfg = JaxConfig(**CFG_KW)
    cfg = MapConfig(**CFG_KW)
    arrays = _jax_state_arrays(jcfg, rng)
    js = _jax_state(arrays)
    ts = state_from_numpy(arrays, "cpu")
    R = np.eye(3, dtype=np.float32)
    for pos in ([0.23, -0.41, 0.1], [-0.05, 0.26, -0.2], [3.0, -5.0, 0.0]):
        js = jcore.move_to(js, jnp.asarray(pos, jnp.float32), jnp.asarray(R), jcfg)
        ts = core.move_to(ts, torch.tensor(pos), torch.from_numpy(R), cfg)
        _assert_states_close(ts, js, 1e-6)
    for d in ([0.31, 0.0, 0.05], [-0.12, -0.27, 0.0]):
        js = jcore.move(js, jnp.asarray(d, jnp.float32), jcfg)
        ts = core.move(ts, torch.tensor(d), cfg)
        _assert_states_close(ts, js, 1e-6)
    steps = [
        (lambda s: jcore.update_variance(s, jcfg), lambda s: core.update_variance(s, cfg)),
        (lambda s: jcore.update_time(s, jcfg), lambda s: core.update_time(s, cfg)),
        (jcore.update_upper_bound_with_valid_elevation, core.update_upper_bound_with_valid_elevation),
        (lambda s: jcore.update_normal(s, s.layers[0], jcfg), lambda s: core.update_normal(s, s.layers[0], cfg)),
        (lambda s: jcore.clear(s, jcfg), lambda s: core.clear(s, cfg)),
    ]
    js2, ts2 = _jax_state(arrays), state_from_numpy(arrays, "cpu")
    for jf, tf in steps:
        js2, ts2 = jf(js2), tf(ts2)
        _assert_states_close(ts2, js2, 1e-6)


def _jax_state_arrays(jcfg, rng):
    """A random map state in the JAX package's dtypes."""
    n = jcfg.cell_n
    layers = rng.normal(0, 1, (7, n, n)).astype(np.float32)
    layers[2] = rng.random((n, n)) > 0.4
    layers[6] = rng.random((n, n)) > 0.7
    return {
        "layers": layers,
        "normal": rng.normal(0, 1, (3, n, n)).astype(np.float32),
        "semantic": np.zeros((0, n, n), np.float32),
        "sem_new": np.zeros((0, n, n), np.float32),
        "id_max": np.zeros((0, n, n), np.uint32),
        "center": np.array([0.3, -0.2, 0.1], np.float32),
        "rotation": np.eye(3, dtype=np.float32),
        "mean_error": np.float32(0.01),
        "additive_mean_error": np.float32(-0.02),
    }


def test_checkpoints_cross_packages(tmp_path):
    rng = np.random.default_rng(9)
    jcfg = JaxConfig(**CFG_KW)
    arrays = _jax_state_arrays(jcfg, rng)
    jem = JaxMap(jcfg)
    jem.state = _jax_state(arrays)
    jem.save_checkpoint(str(tmp_path / "from_jax"))
    tem = ElevationMap(MapConfig(**CFG_KW), device="cpu")
    tem.load_checkpoint(str(tmp_path / "from_jax"))
    _assert_states_close(tem.state, jem.state, 0)

    tem.state = core.update_time(tem.state, tem.cfg)
    tem.save_checkpoint(str(tmp_path / "from_torch.npz"))
    jem2 = JaxMap(jcfg)
    jem2.load_checkpoint(str(tmp_path / "from_torch.npz"))
    _assert_states_close(tem.state, jem2.state, 0)


def test_mapper_refuses_what_is_not_ported():
    tem = ElevationMap(MapConfig(**CFG_KW), device="cpu")
    pts = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError):
        tem.input_pointcloud(pts, ["x", "y", "z"], np.eye(3), np.zeros(3), 0, 0)
    # semantic channels and images are ported: both run and grow their layers
    tem.input_pointcloud(pts, ["x", "y", "z", "rgb"], np.eye(3), np.zeros(3), 0, 0)
    assert tem.semantic_layer_names == ["rgb"] and tem.exists_layer("rgb")
    K = np.array([[20, 0, 32], [0, 20, 24], [0, 0, 1]], np.float32)
    tem.input_image(np.zeros((48, 64), np.float32), ["mask"], np.diag([1.0, -1.0, -1.0]), np.array([0, 0, 1.0]), K, np.zeros(5))
    assert tem.semantic_layer_names == ["rgb", "mask"] and tem.state.semantic.shape[0] == 2
    # polygon queries, initialize_map and plugin layers are ported: without a
    # plugin config there is no plugin layer, and initialize_map refuses too
    # few points
    assert not tem.exists_layer("min_filter") and tem.get_layer("min_filter") is None
    result = np.zeros(3)
    assert tem.get_polygon_traversability(np.array([[0, 0], [0.5, 0], [0, 0.5]], np.float32), result) == 0
    assert result[2] == 0.125
    with pytest.raises(ValueError, match="more than 3"):
        tem.initialize_map(np.zeros((3, 3)))
    # the exact march is ported: an exact-mode map takes a cloud
    exact = ElevationMap(MapConfig(**dict(CFG_KW, raycast_mode="exact")), device="cpu")
    R, t, _ = torch_scenes.robot_pose(0)
    exact.input_pointcloud(torch_scenes.scene_cloud(np.random.default_rng(1), 2000, R, t, 2.0), ["x", "y", "z"], R, t, 0, 0)
    valid = exact.get_layers(["is_valid"])["is_valid"] > 0.5
    assert valid.mean() > 0.2 and np.isfinite(exact.get_layers(["elevation"])["elevation"][valid]).all()


def test_default_device_is_cuda():
    """No device means CUDA; without a card that raises and names the way
    out, and nothing runs on the CPU unasked."""
    cfg = MapConfig(**CFG_KW)
    if torch.cuda.is_available():
        assert ElevationMap(cfg).state.layers.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ElevationMap(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ElevationMap(cfg, device="cuda")
    assert ElevationMap(cfg, device="cpu").state.layers.device.type == "cpu"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    return files + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "torch_scenes.py")]


def _forbidden_imports(path):
    return [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "elevation_mapping_cupy_tpu")]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 16
    rel = {os.path.relpath(p, PKG) for p in files}
    for sub in ("semantic/__init__.py", "semantic/fusions.py", "semantic/update.py", "ops/image.py",
                "plugins/builtin.py", "plugins/manager.py", "ops/polygon.py", "ops/gridmap_filters.py", "utils/hull.py",
                "planeseg/__init__.py", "planeseg/extract.py", "planeseg/postprocess.py", "planeseg/pipeline.py",
                "planeseg/contour.py", "planeseg/ransac.py", "planeseg/draw.py", "utils/map_io.py",
                "runtime/faults.py", "profile.py", "runtime/service.py", "runtime/native/__init__.py",
                "sensor/__init__.py", "sensor/dino.py", "sensor/networks.py", "sensor/image_node.py",
                "sensor/pointcloud.py", "sensor/utils.py", "utils/convert_weights.py", "examples/__init__.py",
                "examples/plane_decomposition_demo.py", "examples/minimal_mapping.py", "examples/semantic_mapping.py",
                "examples/batched_datagen.py", "examples/robot_stack.py", "examples/large_world_sharded.py",
                "tracing.py"):
        assert sub.replace("/", os.sep) in rel, f"the scan does not reach {sub}"
    for path in files:
        assert not _forbidden_imports(path), f"{path} imports {_forbidden_imports(path)}"


@pytest.mark.parametrize("line", [
    "import jax", "import jax.numpy as jnp", "from jax import lax", "import jaxlib",
    "from elevation_mapping_cupy_tpu.semantic import fusions",
    "def f():\n    from elevation_mapping_cupy_tpu import config",
])
def test_import_scan_catches_a_stray_import(tmp_path, line):
    """The scan's own check: a module of the semantic sub-package with one
    such line in it (at top level or inside a function) is caught."""
    src = open(os.path.join(PKG, "semantic", "update.py")).read()
    assert not _forbidden_imports(os.path.join(PKG, "semantic", "update.py"))
    path = tmp_path / "update.py"
    path.write_text(src + "\n" + line + "\n")
    assert _forbidden_imports(str(path))


def test_weights_file_is_a_byte_copy():
    src = os.path.join(REPO, "elevation_mapping_cupy_tpu", "data", "traversability_weights.npz")
    dst = os.path.join(PKG, "data", "traversability_weights.npz")
    assert os.path.getsize(dst) == 1452
    assert filecmp.cmp(src, dst, shallow=False)


def test_chip_smoke_config_is_the_deployed_yaml():
    yaml_path = os.path.join(REPO, "configs", "core_param.yaml")
    lit = torch_scenes.deployed_config()
    assert lit == load_config(yaml_path)
    assert dataclasses.asdict(lit) == dataclasses.asdict(jload_config(yaml_path))
    assert lit.cell_n == 202 and lit.n_ray_steps == 353
    assert lit.azimuth_bins * (lit.n_ray_steps + 2) * lit.raycast_elevation_bins == 512 * 355 * 128


def test_chip_smoke_semantic_config_is_the_mem_yaml():
    """torch_scenes' semantic map: the deployed values with the layers, the
    fusion tables and the weights of ``configs/semantic_mem.yaml``."""
    mem = load_config(os.path.join(REPO, "configs", "semantic_mem.yaml"))
    lit = torch_scenes.semantic_config()
    keys = ("semantic_layers", "pointcloud_channel_fusions", "image_channel_fusions", "average_weight",
            "image_exponential_alpha", "resolution", "map_length")
    for key in keys:
        a, b = getattr(lit, key), getattr(mem, key)
        if key.endswith("_fusions"):  # the loader sorts the table; the lookup does not depend on its order
            a, b = dict(a), dict(b)
        assert a == b, key
    assert lit.replace(**{k: getattr(torch_scenes.deployed_config(), k) for k in keys[:5]}) == torch_scenes.deployed_config()
    assert tuple(lit.semantic_layers) == torch_scenes.MEM_CHANNELS
    assert [lit.fusion_for_channel(c) for c in torch_scenes.MEM_CHANNELS] == ["color"] + ["class_average"] * 3
    allf = lit.replace(pointcloud_channel_fusions=torch_scenes.ALL_FUSIONS_TABLE)
    assert [allf.fusion_for_channel(c) for c in torch_scenes.ALL_FUSIONS_CHANNELS] == [
        "average", "bayesian_inference", "class_bayesian", "class_max", "class_max"]


def test_profile_entry_point_on_cpu(capsys, tmp_path):
    """``python -m elevation_mapping_cupy_torch.profile --cpu``: the JAX
    package's stages and table, and a Chrome trace with --trace."""
    from elevation_mapping_cupy_torch import profile

    torch.set_num_threads(2)
    table = profile.main(["--cpu", "--iters", "2", "--points", "2000", "--trace", str(tmp_path)])
    assert list(table) == ["input_pointcloud", "update_normal", "move_to", "publish", "polygon"]
    assert all(v["mean_ms"] > 0 and v["p99_ms"] >= 0 for v in table.values())
    out = capsys.readouterr().out
    assert "2 iterations x 2000 points on cpu" in out and "mean_ms" in out
    # the program's spans under the stage table, the update's stages among them
    assert "self_ms" in out and "stream_ms" in out
    assert all(f"\n{name} " in out for name in ("mapper.input_pointcloud", "core.update", "core.dilation"))
    assert (tmp_path / "trace.json").stat().st_size > 0
