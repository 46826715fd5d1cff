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

import chip_smoke
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
        R, t, pos = chip_smoke.robot_pose(4 * k)
        pts = chip_smoke.scene_cloud(rng, 6000, R, t, r_max=2.5)
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
    R, t, _ = chip_smoke.robot_pose(0)
    tem.input_pointcloud(chip_smoke.scene_cloud(np.random.default_rng(0), 3000, R, t, 2.5), ["x", "y", "z"], R, t, 0, 0)
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
    with pytest.raises(NotImplementedError):
        tem.input_pointcloud(pts, ["x", "y", "z", "rgb"], np.eye(3), np.zeros(3), 0, 0)
    for call in (tem.input_image, tem.get_polygon_traversability, tem.initialize_map):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError, match="slice 2"):
        ElevationMap(MapConfig(**dict(CFG_KW, raycast_mode="exact")), device="cpu").input_pointcloud(
            np.ones((5, 3), np.float32), ["x", "y", "z"], np.eye(3), np.zeros(3), 0, 0
        )


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


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) >= 12
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "elevation_mapping_cupy_tpu"), f"{path} imports {mod}"


def test_weights_file_is_a_byte_copy():
    src = os.path.join(REPO, "elevation_mapping_cupy_tpu", "data", "traversability_weights.npz")
    dst = os.path.join(PKG, "data", "traversability_weights.npz")
    assert os.path.getsize(dst) == 1452
    assert filecmp.cmp(src, dst, shallow=False)


def test_chip_smoke_config_is_the_deployed_yaml():
    yaml_path = os.path.join(REPO, "configs", "core_param.yaml")
    lit = chip_smoke.deployed_config()
    assert lit == load_config(yaml_path)
    assert dataclasses.asdict(lit) == dataclasses.asdict(jload_config(yaml_path))
    assert lit.cell_n == 202 and lit.n_ray_steps == 353
    assert lit.azimuth_bins * (lit.n_ray_steps + 2) * lit.raycast_elevation_bins == 512 * 355 * 128
