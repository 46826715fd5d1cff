"""The port's post-processing plugins (``elevation_mapping_cupy_torch/plugins``)
and stencil filters against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances: min_filter / max_filter bit for bit (min and max do not depend
on the order of their operands); uniform_smooth and every float plugin
layer within 1e-5 (sums of 9 values in one order, an FMA XLA:CPU may
contract); semantic_filter bit for bit (its packed colours are only
gathered); features_pca channel by channel, equal within 1 or mirrored
(254 - c) within 1 (``torch_scenes.pca_channels``: an eigenvector's sign is
the solver's choice).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu.ops import stencil as jstencil
from elevation_mapping_cupy_tpu.plugins import PluginManager as JaxManager
from elevation_mapping_cupy_tpu.plugins.builtin import REGISTRY as JREG

from elevation_mapping_cupy_torch.ops import stencil
from elevation_mapping_cupy_torch.plugins import PluginManager, PluginParams
from elevation_mapping_cupy_torch.plugins.builtin import REGISTRY, cv2_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 24
CORE = ["elevation", "variance", "is_valid", "traversability", "time", "upper_bound", "is_upper_bound"]
PLUG = ["plug_a", "plug_b"]
SEM = ["grass", "tree", "person", "rgb"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _height_and_mask(rng, n=N, invalid=0.4, nan_cells=0):
    h = rng.uniform(-0.5, 0.5, (n, n)).astype(np.float32)
    mask = (rng.random((n, n)) > invalid).astype(np.float32)
    mask[n // 3 : n // 3 + 5, n // 2 : n // 2 + 6] = 0.0  # a hole wider than one step
    if nan_cells:
        idx = rng.choice(n * n, nan_cells, replace=False)
        h.reshape(-1)[idx] = np.nan
    return h, mask


def _layers(rng, n=N, nan_semantic=False):
    """Core, plugin and semantic stacks and a rotation, as numpy."""
    core = np.zeros((7, n, n), np.float32)
    core[0], core[2] = _height_and_mask(rng, n)
    core[1] = rng.uniform(0.001, 0.1, (n, n))
    core[3] = rng.uniform(0, 1, (n, n))
    core[3][rng.random((n, n)) < 0.2] = 0.0  # cells max_layer_filter's default replaces
    core[4] = rng.uniform(0, 3, (n, n))
    core[5] = core[0] + rng.uniform(0, 0.3, (n, n))
    core[6] = (rng.random((n, n)) < 0.2).astype(np.float32)
    plug = rng.uniform(-0.2, 1.2, (2, n, n)).astype(np.float32)
    base = rng.uniform(0, 1, (n, n))
    sem = np.stack([
        base + 0.3 * rng.uniform(0, 1, (n, n)),
        0.5 * base + 0.6 * rng.uniform(0, 1, (n, n)),
        rng.uniform(0, 1, (n, n)) ** 2,
    ]).astype(np.float32)
    sem[:, :3, :] = 0.0  # unobserved rows: equal scores, the first class wins
    if nan_semantic:
        sem[1, 5, 5:9] = np.nan
        sem[0, 6, 2] = np.nan
    colour = torch_scenes.pack_rgb(rng.integers(0, 256, (n, n, 3)))
    sem = np.concatenate([sem, colour[None]])
    yaw, pitch = 0.7, 0.2
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0], [-np.sin(pitch), 0, np.cos(pitch)]])
    return core, plug, sem, (Rz @ Ry).astype(np.float32)


def _call_both(name, extra, arrays):
    core, plug, sem, R = arrays
    jp = JREG[name](cell_n=N, **extra)
    tp = REGISTRY[name](cell_n=N, **extra)
    want = jp(jnp.asarray(core), CORE, jnp.asarray(plug), PLUG, jnp.asarray(sem), SEM, jnp.asarray(R), {})
    got = tp(torch.from_numpy(core), CORE, torch.from_numpy(plug), PLUG, torch.from_numpy(sem), SEM,
             torch.from_numpy(R), {})
    assert isinstance(got, torch.Tensor) and got.shape == (N, N)
    return got.numpy().astype(np.float32), np.asarray(want, np.float32)


# ---------------------------------------------------------------------------
# the stencil filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("size, iterations", [(1, 2), (2, 3), (5, 5)])
def test_extreme_filters_match_jax_bit_for_bit(mode, size, iterations):
    """min_filter / max_filter against the JAX package's offset loop, bit
    for bit, at the YAML's s=1, 2 iterations, at s=2 and at the plugin's
    default s=5, 5 iterations (the flat-index wrap joins a row's end to the
    next row's start); a few valid cells hold NaN, which propagates."""
    rng = np.random.default_rng(100 + size)
    h, mask = _height_and_mask(rng, nan_cells=3)
    jfn, tfn = (jstencil.min_filter, stencil.min_filter) if mode == "min" else (jstencil.max_filter, stencil.max_filter)
    want = np.asarray(jfn(jnp.asarray(h), jnp.asarray(mask), size, iterations))
    got = tfn(torch.from_numpy(h), torch.from_numpy(mask), size, iterations).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(got).any() and np.isfinite(got).mean() > 0.5


@pytest.mark.parametrize("mode", ["min", "max"])
def test_extreme_filters_stop_once_every_cell_is_filled(mode):
    """The done gate: one invalid cell, filled on the first iteration; the
    next iterations must leave it (min_filter would otherwise keep taking
    new minima through it)."""
    rng = np.random.default_rng(7)
    h, _ = _height_and_mask(rng)
    mask = np.ones_like(h)
    mask[10, 10] = 0.0
    jfn, tfn = (jstencil.min_filter, stencil.min_filter) if mode == "min" else (jstencil.max_filter, stencil.max_filter)
    want = np.asarray(jfn(jnp.asarray(h), jnp.asarray(mask), 2, 4))
    got = tfn(torch.from_numpy(h), torch.from_numpy(mask), 2, 4).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("passes, size, shape", [(2, 3, (N, N)), (1, 5, (N, N)), (2, 5, (3, 4)), (1, 9, (3, 4))])
def test_uniform_smooth_matches_jax(passes, size, shape):
    """Symmetric padding at pad 1, pad 2 and pads wider than the map (the
    reflection repeats), within 1e-6."""
    rng = np.random.default_rng(8)
    h = rng.uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jstencil.uniform_smooth(jnp.asarray(h), passes=passes, size=size))
    got = stencil.uniform_smooth(torch.from_numpy(h), passes=passes, size=size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n, pad", [(5, 1), (5, 2), (3, 7), (1, 2)])
def test_symmetric_index_is_numpys_symmetric_pad(n, pad):
    x = np.arange(n)
    assert stencil.symmetric_index(n, pad, torch.device("cpu")).tolist() == np.pad(x, pad, mode="symmetric").tolist()


# ---------------------------------------------------------------------------
# the ten plugins
# ---------------------------------------------------------------------------

FLOAT_CASES = {
    "min_filter": {"dilation_size": 2, "iteration_n": 3},
    "max_filter": {"dilation_size": 2, "iteration_n": 3},
    "smooth_filter": {"input_layer_name": "plug_a"},
    "smooth_filter:core": {"input_layer_name": "traversability"},
    "smooth_filter:unknown": {"input_layer_name": "nothing"},
    "inpainting": {"method": "telea"},
    "inpainting:ns": {"method": "ns"},
    "erosion": {"input_layer_name": "traversability", "kernel_size": 3, "iterations": 2, "reverse": True},
    "erosion:semantic": {"input_layer_name": "tree", "kernel_size": 5},
    "erosion:default": {"input_layer_name": "nothing", "default_layer_name": "plug_b"},
    "semantic_traversability": {
        "layers": ["traversability", "grass", "nothing"], "thresholds": [0.3, 0.5, 0.1],
        "type": ["traversability", "semantic", "semantic"],
    },
    "max_layer_filter": {
        "layers": ["traversability", "plug_a", "nothing"], "reverse": [True, False], "min_or_max": "max",
        "thresholds": [False, 0.4], "scales": [1.0, 2.0],
    },
    "max_layer_filter:min": {
        "layers": ["traversability", "grass"], "reverse": [False], "min_or_max": "min",
        "thresholds": [0.5], "scales": [3], "default_value": "elevation",
    },
    "max_layer_filter:none": {"layers": ["nothing"], "default_value": 0.25},
    "robot_centric_elevation": {"resolution": 0.1, "threshold": 0.05, "use_threshold": False},
    "robot_centric_elevation:threshold": {"resolution": 0.04, "threshold": 0.05, "use_threshold": True},
}


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_float_plugin_matches_jax(case):
    """Each plugin that computes heights or costs, against the JAX package's
    on the same core, plugin and semantic layers and rotation, within 1e-5
    (robot_centric_elevation's R[2,:]·r is contracted into FMAs by XLA:CPU);
    NaN where JAX has NaN."""
    name = case.split(":")[0]
    got, want = _call_both(name, FLOAT_CASES[case], _layers(np.random.default_rng(11)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nan_semantic", [False, True])
def test_semantic_filter_matches_jax_bit_for_bit(nan_semantic):
    """The packed VOC colour of the first maximal class, over core, plugin
    and semantic names matched as regular expressions in that order; a NaN
    score counts as the maximum, as jnp.argmax counts it."""
    extra = {"classes": ["grass", "tr.*", "person", "plug_b"]}
    got, want = _call_both("semantic_filter", extra, _layers(np.random.default_rng(12), nan_semantic=nan_semantic))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert len(np.unique(_bits(got))) == 4
    got, want = _call_both("semantic_filter", {"classes": ["sky"]}, _layers(np.random.default_rng(12)))
    np.testing.assert_array_equal(_bits(got), _bits(want))  # no class layer: every cell the first colour


@pytest.mark.parametrize("nan_feature", [False, True])
def test_features_pca_matches_jax_by_channel(nan_feature):
    """Three principal axes of the clipped class layers (the plugin layer
    plug_a, whose values pass 1, is clipped too), packed into colours:
    each channel equal to JAX's within 1, or mirrored (254 - c, the
    truncation of 255 - x) within 1 where the two solvers picked opposite
    signs. A NaN feature makes every
    cell 0 in both."""
    arrays = _layers(np.random.default_rng(13), nan_semantic=nan_feature)
    got, want = _call_both("features_pca", {"process_layer_names": ["plug_a", "grass", "tree", "person"]}, arrays)
    if nan_feature:
        assert not _bits(want).any() and not _bits(got).any()
        return
    channels = torch_scenes.pca_channels(got, want)
    print("features_pca channels against JAX:", channels)
    assert all(c in ("equal", "mirrored") for c in channels)
    assert len(np.unique(_bits(got))) > N * N // 2
    got, want = _call_both("features_pca", {"process_layer_names": ["sky"]}, arrays)
    assert not got.any() and not want.any()


@pytest.mark.parametrize("name", ["inpainting", "erosion"])
def test_host_plugins_without_cv2_match_jax(monkeypatch, name):
    """Inpainting and erosion where cv2 cannot be imported:
    neighbour-mean diffusion on the map's device and a NumPy window
    minimum, against the JAX package's fallbacks."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not cv2_available()
    extra = {"method": "telea"} if name == "inpainting" else {"kernel_size": 3, "iterations": 2}
    got, want = _call_both(name, extra, _layers(np.random.default_rng(14)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_host_plugins_with_cv2_differ_from_the_fallback():
    """Where cv2 is installed its branch runs, and inpainting's result is
    not the diffusion's."""
    pytest.importorskip("cv2")
    assert cv2_available()
    arrays = _layers(np.random.default_rng(15))
    got, _ = _call_both("inpainting", {"method": "telea"}, arrays)
    holes = arrays[0][2] < 0.5
    assert np.isfinite(got).all() and np.unique(got[holes]).size < holes.sum()  # 8-bit steps


def test_inpainting_without_any_valid_cell_returns_elevation():
    core, plug, sem, R = _layers(np.random.default_rng(16))
    core[2] = 0.0
    got, want = _call_both("inpainting", {}, (core, plug, sem, R))
    np.testing.assert_array_equal(got, core[0])
    np.testing.assert_array_equal(want, core[0])


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_manager_persistence_matches_jax():
    """A plugin reading another plugin's layer sees zeros before that layer
    is first computed and its last value after, in both managers; unknown
    names are ignored."""
    params = [
        PluginParams("smooth_filter", "smooth_of_min", False, True),
        PluginParams("min_filter", "min", True, True),
        PluginParams("max_layer_filter", "max_of_both", False, False),
    ]
    extra = [{"input_layer_name": "min"}, {"dilation_size": 1, "iteration_n": 2},
             {"layers": ["smooth_of_min", "min"], "reverse": [False, False], "thresholds": [False, False],
              "scales": [1.0, 1.0]}]
    core, _, sem, R = _layers(np.random.default_rng(17))
    jm, tm = JaxManager(N), PluginManager(N, device="cpu")
    jm.init([PluginParams(p.name, p.layer_name, p.fill_nan, p.is_height_layer) for p in params], extra)
    tm.init(params, extra)
    assert tm.layer_names == jm.layer_names and tm.plugin_names == jm.plugin_names
    assert tm.layers.shape == (3, N, N) and not tm.layers.any()
    args_j = (jnp.asarray(core), CORE, jnp.asarray(sem[:3]), SEM[:3], jnp.asarray(R))
    args_t = (torch.from_numpy(core), CORE, torch.from_numpy(sem[:3]), SEM[:3], torch.from_numpy(R))
    for name in ("smooth_of_min", "min", "max_of_both", "smooth_of_min", "nothing", "max_of_both"):
        jm.update_with_name(name, *args_j)
        tm.update_with_name(name, *args_t)
        for nm in tm.layer_names:
            want, got = np.asarray(jm.get_map_with_name(nm)), tm.get_map_with_name(nm).numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{nm} after {name}")
        if name == "smooth_of_min" and not tm.get_map_with_name("min").any():
            assert not tm.get_map_with_name("smooth_of_min").any()  # smoothed zeros
    assert tm.get_map_with_name("nothing") is None and tm.get_param_with_name("min").fill_nan
    with pytest.raises(ValueError, match="unknown plugin"):
        tm.init([PluginParams("no_such_plugin", "x")], [{}])


@pytest.mark.parametrize("path", ["configs/plugin_config.yaml", "tests/fixtures/plugin_config.yaml"])
def test_load_plugin_settings_matches_jax(path):
    jm, tm = JaxManager(N), PluginManager(N, device="cpu")
    jm.load_plugin_settings(os.path.join(REPO, path))
    tm.load_plugin_settings(os.path.join(REPO, path))
    assert tm.plugin_params == [PluginParams(**vars(p)) for p in jm.plugin_params]
    assert [type(p).__name__ for p in tm.plugins] == [type(p).__name__ for p in jm.plugins]
    assert [vars(p) for p in tm.plugins] == [vars(p) for p in jm.plugins]


def test_chip_smoke_plugin_literal_is_the_yaml():
    """The card's machine has no PyYAML: tests/torch_scenes.py carries
    configs/plugin_config.yaml as a literal, which must load the same
    plugins with the same settings."""
    from_yaml = PluginManager(N, device="cpu")
    from_yaml.load_plugin_settings(os.path.join(REPO, "configs", "plugin_config.yaml"))
    lit = PluginManager(N, device="cpu")
    lit.init(*torch_scenes.plugin_settings())
    assert lit.plugin_params == from_yaml.plugin_params
    assert [vars(p) for p in lit.plugins] == [vars(p) for p in from_yaml.plugins]
    both = PluginManager(N, device="cpu")
    both.init(*torch_scenes.plugin_settings(torch_scenes.PLUGIN_SETTINGS + torch_scenes.SEMANTIC_PLUGIN_SETTINGS))
    assert both.plugin_names[-2:] == ["semantic_filter", "features_pca"]


def test_pca_channel_rule():
    """torch_scenes.pca_channels: a channel one off is equal, the truncated
    mirror trunc(255 - x) of c = trunc(x) is mirrored, anything else fails."""
    x = np.random.default_rng(18).uniform(0, 255, (3, 40, 40))
    c = np.floor(x).astype(np.uint32)
    pack = lambda ch: ((ch[0] << 16) | (ch[1] << 8) | ch[2]).astype(np.uint32).view(np.float32)  # noqa: E731
    mirror = c.copy()
    mirror[1] = np.floor(255 - x[1]).astype(np.uint32)
    off = c.copy()
    off[2] = np.minimum(off[2] + 1, 255)
    assert torch_scenes.pca_channels(pack(mirror), pack(c)) == ["equal", "mirrored", "equal"]
    assert torch_scenes.pca_channels(pack(off), pack(c)) == ["equal", "equal", "equal"]
    bad = c.copy()
    bad[0, 3, 3] = (bad[0, 3, 3] + 128) % 256
    with pytest.raises(AssertionError, match="channel 0"):
        torch_scenes.pca_channels(pack(bad), pack(c))
