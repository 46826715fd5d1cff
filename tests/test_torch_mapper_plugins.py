"""The port's ``ElevationMap(device="cpu")`` post-processing surface against
the JAX mapper: plugin layers through every export, the named getters,
polygon safety queries, ``initialize_map``, and checkpoints crossing between
the packages before a plugin export.

Both maps are driven through the same 3-frame trajectory with
``tests/fixtures/plugin_config.yaml``; the core layers agree within the
mapper tests' 1e-4. The plugin and query comparisons then start both from
the JAX map's state, so that they test the post-processing alone: plugin
layers within 1e-5 (NaN where JAX has NaN), polygon results, counts and
hull rings equal (the mean cost within 1e-6 relative: a float32 sum over
the polygon in another order), initialize_map within 1e-5.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu import load_config as jload_config
from elevation_mapping_cupy_tpu.mapper import ElevationMap as JaxMap

from elevation_mapping_cupy_torch import load_config
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.state import state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEM_YAML = os.path.join(REPO, "configs", "semantic_mem.yaml")
PLUGIN_YAML = os.path.join(REPO, "tests", "fixtures", "plugin_config.yaml")
SMALL = dict(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=4096, raycast_mode="polar")
CHANNELS = ["x", "y", "z", "rgb", "grass", "tree", "person"]
CORE = ["elevation", "variance", "is_valid", "traversability", "time", "upper_bound", "is_upper_bound"]
GETTERS = ["elevation", "variance", "traversability", "time", "upper_bound", "is_upper_bound"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _drive(frames=3, seed=50):
    """Both mappers with the plugin fixture through ``frames`` frames of the
    smoke scene with a colour and three class channels."""
    jem = JaxMap(jload_config(MEM_YAML, **SMALL), plugin_config_file=PLUGIN_YAML)
    tem = ElevationMap(load_config(MEM_YAML, **SMALL), plugin_config_file=PLUGIN_YAML, device="cpu")
    rng = np.random.default_rng(seed)
    for k in range(frames):
        R, t, pos = torch_scenes.robot_pose(4 * k)
        n = 3000
        cloud = np.concatenate([
            torch_scenes.scene_cloud(rng, n, R, t, r_max=2.5),
            torch_scenes.pack_rgb(rng.integers(0, 256, (n, 3)))[:, None],
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
        ], axis=1)
        for em in (jem, tem):
            em.move_to(pos, R)
            em.input_pointcloud(cloud, CHANNELS, R, t, 0.0, 0.0)
    return jem, tem


@pytest.fixture(scope="module")
def driven():
    """The two mappers after the trajectory, and the JAX map's state then."""
    jem, tem = _drive()
    got, want = tem.get_layers(CORE), jem.get_layers(CORE)
    for name in CORE:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, err_msg=name)
    return jem, tem, jem.state


def _same_state(driven, layers=None):
    """Both maps on the JAX map's state after the trajectory (its core
    layers replaced by ``layers`` if given), plugin layers back at zero."""
    jem, tem, start = driven
    if layers is not None:
        start = start._replace(layers=jnp.asarray(layers))
    jem.state = start
    tem.cfg = tem.cfg.replace(semantic_layers=tuple(jem.cfg.semantic_layers))
    tem.state = state_from_numpy(start, "cpu")
    jem.plugin_manager.layers[...] = 0.0
    tem.plugin_manager.layers.zero_()
    return jem, tem


def _assert_plugin_layers_match(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(want[name]), err_msg=name)
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)


def test_plugin_exports_match_jax_mapper(driven):
    """Every plugin layer of the fixture through get_map_with_name_ref, then
    get_layers mixing core, semantic and plugin names (core and semantic
    layers first, as the JAX mapper orders them), get_layer uncropped, and
    an unknown name."""
    jem, tem = _same_state(driven)
    names = tem.plugin_manager.layer_names
    assert names == jem.plugin_manager.layer_names and len(names) == 8
    assert all(tem.exists_layer(nm) for nm in names) and not tem.exists_layer("sky")
    n = tem.cell_n
    got, want = {}, {}
    for nm in names:
        got[nm] = np.full((n - 2, n - 2), 7.0, np.float32)
        want[nm] = np.full((n - 2, n - 2), 7.0, np.float32)
        tem.get_map_with_name_ref(nm, got[nm])
        jem.get_map_with_name_ref(nm, want[nm])
    _assert_plugin_layers_match(got, want)
    assert np.isnan(got["min_filter"]).any() and np.isfinite(got["smooth"]).all()
    mixed = ["smooth", "elevation", "grass", "min_filter", "sky", "rgb", "erosion", "traversability"]
    got_l, want_l = tem.get_layers(mixed), jem.get_layers(mixed)
    assert list(got_l) == list(want_l) == ["elevation", "grass", "rgb", "traversability", "smooth", "min_filter", "erosion"]
    np.testing.assert_array_equal(_bits(got_l["rgb"]), _bits(want_l["rgb"]))
    _assert_plugin_layers_match({k: v for k, v in got_l.items() if k != "rgb"},
                                {k: v for k, v in want_l.items() if k != "rgb"})
    for nm in ["max_layer", "elevation", "person"]:
        g, w = tem.get_layer(nm), np.asarray(jem.get_layer(nm))
        assert isinstance(g, np.ndarray) and g.shape == (n, n)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=nm)
    assert tem.get_layer("sky") is None
    buf = np.full((n - 2, n - 2), 3.0, np.float32)
    tem.get_map_with_name_ref("sky", buf)
    assert (buf == 3.0).all()


def test_named_getters_match_jax_mapper(driven):
    """The six layer getters (unflipped, cropped), get_normal_maps and
    get_normal_ref; a getter's array is the caller's own."""
    jem, tem = _same_state(driven)
    for name in GETTERS:
        got, want = getattr(tem, f"get_{name}")(), np.asarray(getattr(jem, f"get_{name}")())
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
    var = tem.get_variance()
    var[...] = -1.0
    assert float(tem.state.layers[1, 1, 1]) != -1.0
    np.testing.assert_array_equal(_bits(tem.get_normal_maps()), _bits(jem.get_normal_maps()))
    n = tem.cell_n
    refs = [np.zeros((n - 2, n - 2), np.float32) for _ in range(6)]
    tem.get_normal_ref(*refs[:3])
    jem.get_normal_ref(*refs[3:])
    for a, b in zip(refs[:3], refs[3:]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# a triangle about the map's centre, a square past the map's
# edge (clipped), a sliver of area < 0.001 and a square over 2 unsafe cells
POLYGONS = {
    "inside": [[-0.3, -0.4], [0.9, -0.2], [0.1, 0.8]],
    "clipped": [[-3.0, -3.0], [3.0, -3.0], [3.0, 3.0], [-3.0, 3.0]],
    "degenerate": [[0.0, 0.0], [0.01, 0.0], [0.0, 0.01]],
    "few_unsafe": [[0.02, 0.02], [0.38, 0.02], [0.38, 0.18], [0.02, 0.18]],
    "nonagon": [[np.cos(a) * 0.8, np.sin(a) * 0.8] for a in np.linspace(0, 2 * np.pi, 9, endpoint=False)],
}


@pytest.mark.parametrize("case", sorted(POLYGONS))
def test_polygon_queries_match_jax_mapper(driven, case):
    """get_polygon_traversability and get_untraversable_polygon: is_safe
    and the area equal, the mean cost within 1e-6 relative, the hull's
    vertex count and ring equal (no hull under 3 unsafe cells)."""
    layers = np.array(driven[2].layers)
    # the middle of the map valid and safe (the sensor sees no closer than
    # 0.4 m), then a patch of unsafe cells there, or two unsafe cells
    layers[2, 14:29, 14:29] = 1.0
    layers[3, 14:29, 14:29] = 1.0
    if case == "few_unsafe":
        layers[3, 22:24, 21] = 0.05
    else:
        layers[3, 17:22, 18:23] = 0.05
    jem, tem = _same_state(driven, layers)
    poly = np.asarray(POLYGONS[case], np.float32) + jem.center[:2]
    res_t, res_j = np.zeros(3), np.zeros(3)
    n_t = tem.get_polygon_traversability(poly, res_t)
    n_j = jem.get_polygon_traversability(poly, res_j)
    assert n_t == n_j and res_t[0] == res_j[0] and res_t[2] == res_j[2]
    np.testing.assert_allclose(res_t[1], res_j[1], rtol=1e-6, atol=0)
    ring_t, ring_j = np.zeros((n_t, 2)), np.zeros((n_j, 2))
    tem.get_untraversable_polygon(ring_t)
    jem.get_untraversable_polygon(ring_j)
    np.testing.assert_array_equal(ring_t, ring_j)
    if case in ("inside", "clipped"):
        assert n_t >= 4 and res_t[0] == 0.0
    if case in ("few_unsafe", "degenerate"):
        assert n_t == 0 and res_t[0] == 0.0


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_initialize_map_matches_jax_mapper(driven, method):
    """Sparse points through griddata, two dilation fills and the upper
    bound, from the mapped state (initialize_map clears it first)."""
    jem, tem = _same_state(driven)
    # one-cell dilation: the JAX package's eager 5x5 fill compiles for ~45 s
    # on the CPU (the port's dilation_fill is held to it in test_torch_ops)
    for em in (jem, tem):
        em.cfg = em.cfg.replace(dilation_size_initialize=1)
    c = jem.center
    pts = np.array([[0.8, 0.7, 0.1], [-0.9, 0.6, 0.25], [0.5, -1.1, -0.05], [-0.7, -0.8, 0.3],
                    [0.05, 0.1, 0.15], [1.2, -0.2, 0.0]]) + np.array([c[0], c[1], c[2]])
    for em in (jem, tem):
        em.initialize_map(pts, method)
    names = ["elevation", "variance", "is_valid", "upper_bound", "is_upper_bound"]
    got, want = tem.get_layers(names), jem.get_layers(names)
    for name in names:
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(want[name]), err_msg=name)
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=name)
    assert (got["is_valid"] > 0.5).mean() > 0.2
    with pytest.raises(ValueError, match="more than 3"):
        tem.initialize_map(pts[:2], method)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_across_packages_then_plugin_exports(driven, tmp_path, direction):
    """A checkpoint saved by one package and loaded by the other: the loaded
    map's plugin layers equal the saving map's."""
    jem, tem = _same_state(driven)
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_torch":
        jem.save_checkpoint(path)
        saver, loader = jem, ElevationMap(load_config(MEM_YAML, **SMALL), plugin_config_file=PLUGIN_YAML, device="cpu")
    else:
        tem.save_checkpoint(path)
        saver, loader = tem, JaxMap(jload_config(MEM_YAML, **SMALL), plugin_config_file=PLUGIN_YAML)
    loader.load_checkpoint(path)
    names = ["inpaint", "max_filter", "robot_centric_elevation", "semantic_traversability"]
    got, want = loader.get_layers(names), saver.get_layers(names)
    _assert_plugin_layers_match(got, want)


@pytest.mark.parametrize("case", ["triangle", "concave", "grid_aligned", "past_edge", "nine"])
def test_polygon_mask_and_area_match_jax(case):
    """ops/polygon.py against the JAX package's on its own: the mask (every
    padded edge, colinear and on-segment cells, the bbox gate) and the
    shoelace area over the first n vertices."""
    from elevation_mapping_cupy_tpu.ops import polygon as jpoly

    from elevation_mapping_cupy_torch.ops import polygon as tpoly

    cfg_t, cfg_j = load_config(MEM_YAML, **SMALL), jload_config(MEM_YAML, **SMALL)
    poly = {
        "triangle": [[0.13, -0.41], [1.27, 0.33], [-0.52, 1.08]],
        "concave": [[-1.0, -1.0], [1.0, -1.0], [0.0, 0.0], [1.0, 1.0], [-1.0, 1.0]],
        "grid_aligned": [[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
        "past_edge": [[-3.0, -0.2], [2.5, -2.8], [1.9, 3.3]],
        "nine": [[np.cos(a) * 1.3, np.sin(a) * 0.9] for a in np.linspace(0, 2 * np.pi, 9, endpoint=False)],
    }[case]
    nv = len(poly)
    padded = np.zeros((max(8, 1 << int(np.ceil(np.log2(nv)))), 2), np.float32)
    padded[:nv] = poly
    centre = np.array([0.07, -0.03], np.float32)
    got = tpoly.polygon_mask(torch.from_numpy(padded), nv, torch.from_numpy(centre), cfg_t)
    want = jpoly.polygon_mask(jnp.asarray(padded), jnp.asarray(nv), jnp.asarray(centre), cfg_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0
    area = tpoly.polygon_area(torch.from_numpy(padded), nv)
    np.testing.assert_allclose(float(area), float(jpoly.polygon_area(jnp.asarray(padded), jnp.asarray(nv))), rtol=1e-6)
