"""The port's semantic (MEM) fusions against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through
``elevation_mapping_cupy_tpu/semantic`` and ``elevation_mapping_cupy_torch/
semantic``. On the CPU the port's scatter-adds run K1's plain version and the
JAX side its XLA scatter. Tolerances are the JAX suite's own
(tests/test_semantic.py): float layers 1e-4, class-max sums 1e-3; class ids
and packed colours must agree bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import pack_class as np_encode_max
from chip_smoke import pack_rgb as np_pack_rgb
from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import core as jcore
from elevation_mapping_cupy_tpu import init_state as jinit_state
from elevation_mapping_cupy_tpu.nn.traversability import default_weights as jdefault_weights
from elevation_mapping_cupy_tpu.ops import scatter as jscatter
from elevation_mapping_cupy_tpu.ops.geometry import associate_points as jassociate
from elevation_mapping_cupy_tpu.semantic import fusions as JF
from elevation_mapping_cupy_tpu.semantic import update as JU

from elevation_mapping_cupy_torch import MapConfig, core
from elevation_mapping_cupy_torch.nn.traversability import default_weights
from elevation_mapping_cupy_torch.ops import scatter
from elevation_mapping_cupy_torch.ops.geometry import PointAssociation
from elevation_mapping_cupy_torch.semantic import fusions as F
from elevation_mapping_cupy_torch.semantic import update as U
from elevation_mapping_cupy_torch.state import init_state, state_from_numpy, state_to_numpy

CFG_KW = dict(resolution=0.1, map_length=4.0, max_ray_length=1.5, max_points=4096, raycast_mode="polar")
N_POINTS = 3000
R_EYE = np.eye(3, dtype=np.float32)
T_SENSOR = np.array([0.0, 0.0, 0.6], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# ---------------------------------------------------------------------------
# packing helpers, bit for bit
# ---------------------------------------------------------------------------

def test_decode_max_matches_jax_bit_for_bit():
    """Every float16 pattern under ids that reach 0xFFFF (NaN and infinity
    patterns of the packed float included)."""
    rng = np.random.default_rng(0)
    half = np.arange(1 << 16, dtype=np.uint32)
    ids = np.concatenate([rng.integers(0, 1 << 16, (1 << 16) - 6), [0, 1, 0x7F80, 0x8000, 0xFF80, 0xFFFF]]).astype(np.uint32)
    mer = ((ids << 16) | half).view(np.float32)
    jp, jc = JF.decode_max(jnp.asarray(mer))
    tp, tc = F.decode_max(torch.from_numpy(mer))
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))
    np.testing.assert_array_equal(tc.numpy().astype(np.uint32), np.asarray(jc))
    assert tc.dtype == torch.int64 and int(tc.max()) == 0xFFFF


def test_encode_max_matches_jax_bit_for_bit():
    """Probabilities over and past the float16 range (subnormal halves, ties
    between two halves, overflow to infinity, negatives) under ids up to
    0xFFFF: the float32 -> float16 rounding is to nearest even in both."""
    rng = np.random.default_rng(1)
    prob = np.concatenate([
        rng.uniform(0, 1, 4000), rng.uniform(-70000, 70000, 2000), 10.0 ** rng.uniform(-9, 5, 2000),
        # exact midpoints between neighbouring halves near 1 and near 2048
        1.0 + (2.0 * np.arange(200) + 1) * 2.0 ** -11, 2048.0 + np.arange(200) + 0.5 * 2,
        [0.0, -0.0, 65504.0, 65519.9, 65520.0, 6e-8, 2.9e-8, 3.0e-8],
    ]).astype(np.float32)
    cls = rng.integers(0, 1 << 16, prob.shape[0]).astype(np.uint32)
    cls[:4] = [0, 0x7F80, 0x8000, 0xFFFF]
    want = JF.encode_max(jnp.asarray(prob), jnp.asarray(cls))
    got = F.encode_max(torch.from_numpy(prob), torch.from_numpy(cls.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np_encode_max(prob, cls)))


def test_rgb_float_to_uint_matches_jax():
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 5), np.arange(0, 256, 17), indexing="ij"), -1).reshape(-1, 3)
    packed = np_pack_rgb(rgb)
    # a packed colour is a denormal (red below 128) or a normal number below 2.4e-38
    assert np.all(packed < 2.4e-38) and np.mean(packed < 1.1754944e-38) > 0.49
    want = JF.rgb_float_to_uint(jnp.asarray(packed))
    got = F.rgb_float_to_uint(torch.from_numpy(packed))
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]).astype(np.int64))
        np.testing.assert_array_equal(got[c].numpy(), rgb[:, c])


def test_uint_to_rgb_float_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (5000, 3))
    rgb[:3] = [[0, 0, 0], [255, 255, 255], [0, 0, 1]]
    want = JF.uint_to_rgb_float(*(jnp.asarray(rgb[:, c].astype(np.uint32)) for c in range(3)))
    got = F.uint_to_rgb_float(*(torch.from_numpy(rgb[:, c]) for c in range(3)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np_pack_rgb(rgb)))
    back = F.rgb_float_to_uint(got)
    np.testing.assert_array_equal(torch.stack(back, 1).numpy(), rgb)


def test_scatter_max_matches_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 500, 4000).astype(np.int32)
    vals = rng.normal(0, 1, 4000).astype(np.float32)
    mask = rng.random(4000) > 0.3
    want = jscatter.scatter_max(500, jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(mask), -np.inf)
    got = scatter.scatter_max(500, torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(mask), -np.inf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("distinct, size", [(5, 32), (32, 32), (40, 32), (39, 8), (0, 4)])
def test_smallest_unique_is_jnp_unique_with_a_size(distinct, size):
    """The static bucketing: the ``size`` smallest distinct ids in unsigned
    order (ids past 2^31 sort last, not first), padded with 0xFFFFFFFF."""
    rng = np.random.default_rng(4)
    pool = np.concatenate([rng.integers(0, 1 << 16, max(distinct - 2, 0)), [0x80000001, 0xFFFFFFFE][: min(distinct, 2)]])
    cand = rng.choice(pool, 3000).astype(np.uint32) if distinct else np.zeros(0, np.uint32)
    want = jnp.unique(jnp.asarray(cand), size=size, fill_value=jnp.uint32(0xFFFFFFFF))
    got = scatter.smallest_unique(torch.from_numpy(cand.astype(np.int64)), size, F.UNIQUE_FILL)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


# ---------------------------------------------------------------------------
# the six fusions, each against its JAX function
# ---------------------------------------------------------------------------

def _cloud(rng, n=N_POINTS, pad=4096):
    pts = rng.uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.1, 0.3, n)
    padded = np.zeros((pad, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros(pad, bool)
    mask[:n] = True
    return padded, mask


def _shared_assoc(padded, mask, jcfg):
    """One association (the JAX package's) handed to both fusions."""
    ja = jassociate(jnp.asarray(padded), jnp.asarray(mask), jnp.asarray(R_EYE), jnp.asarray(T_SENSOR), jcfg)
    ta = PointAssociation(**{
        f: torch.from_numpy(np.array(getattr(ja, f))) for f in PointAssociation._fields
    })
    return ja, ta


def _pad_feats(feats, pad=4096):
    out = np.zeros((pad, feats.shape[1]), np.float32)
    out[: len(feats)] = feats
    return out


def _uniform(lo, hi, n_lay):
    return lambda rng, n: rng.uniform(lo, hi, (n, n_lay)).astype(np.float32)


def _class_max_feats(n_ids, n_lay):
    def make(rng, n):
        prob = rng.uniform(0.2, 1.0, (n, n_lay)).astype(np.float32)
        cls = rng.integers(1, 1 + n_ids, (n, n_lay)).astype(np.uint32)
        return np_encode_max(prob, cls)
    return make


def _color_feats(n_lay):
    return lambda rng, n: np_pack_rgb(rng.integers(0, 256, (n, n_lay, 3)))


FUSION_CASES = {
    "average": ("average", _uniform(0, 1, 2)),
    "class_average": ("class_average", _uniform(0, 1, 3)),
    "bayesian_inference": ("bayesian_inference", _uniform(0, 1, 2)),
    "class_bayesian": ("class_bayesian", _uniform(0, 1, 3)),
    "class_bayesian_negative_features": ("class_bayesian", _uniform(-1, 1, 2)),
    "class_max": ("class_max", _class_max_feats(5, 2)),
    "class_max_over_32_ids": ("class_max", _class_max_feats(45, 1)),
    "color": ("color", _color_feats(2)),
}


def _assert_semantic_close(got, want, fusion, tag):
    """got: port tensors, want: JAX arrays, as (semantic, sem_new, id_max)."""
    sem_t, new_t, id_t = (x.numpy() for x in got)
    sem_j, new_j, id_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(id_t.astype(np.uint32), id_j, err_msg=f"{tag} id_max")
    if fusion == "color":
        np.testing.assert_array_equal(_bits(sem_t), _bits(sem_j), err_msg=f"{tag} packed colour")
    else:
        np.testing.assert_allclose(sem_t, sem_j, atol=1e-4, err_msg=f"{tag} semantic")
    np.testing.assert_allclose(new_t, new_j, atol=1e-3 if fusion == "class_max" else 1e-4, err_msg=f"{tag} sem_new")


@pytest.mark.parametrize("case", list(FUSION_CASES))
def test_fusion_matches_jax(case):
    """Two updates in a row through one fusion on one shared association,
    with a move_to (a shift by whole cells, semantic stacks included)
    between them."""
    fusion, make_feats = FUSION_CASES[case]
    rng = np.random.default_rng(sorted(FUSION_CASES).index(case))
    n_lay = make_feats(rng, 1).shape[1]
    names = tuple(f"l{k}" for k in range(n_lay + 1))  # one layer more than the fusion owns
    kw = dict(CFG_KW, semantic_layers=names, pointcloud_channel_fusions=(("default", fusion),))
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    n = cfg.cell_n
    js, ts = jinit_state(jcfg), init_state(cfg, "cpu")
    lays = list(range(1, n_lay + 1))
    for u in range(2):
        padded, mask = _cloud(rng)
        feats = _pad_feats(make_feats(rng, N_POINTS))
        ja, ta = _shared_assoc(padded, mask, jcfg)
        cnt = np.zeros(n * n, np.float32)
        keep = np.asarray(ja.mask) & (rng.random(len(mask)) > 0.2)  # some points are outliers of the elevation
        np.add.at(cnt, np.asarray(ja.flat_idx)[keep], 1.0)
        cnt = cnt.reshape(n, n)
        persist = fusion in JF.PERSISTENT_NEW
        # the per-update buffer starts at 0; the Gaussian posterior's prior
        # variance is set to 0.5 here, since from 0 it never moves (the
        # reference's frozen posterior, in fusions.py's list of quirks)
        fresh = 0.5 if fusion == "bayesian_inference" else 0.0
        jup = JF.SemanticUpdate(js.semantic, js.sem_new if persist else jnp.full_like(js.sem_new, fresh), js.id_max)
        tup = F.SemanticUpdate(ts.semantic, ts.sem_new if persist else torch.full_like(ts.sem_new, fresh), ts.id_max)
        jup = JF.POINTCLOUD_FUSIONS[fusion](jup, ja, jnp.asarray(feats), lays, jnp.asarray(cnt), jcfg)
        tup = F.POINTCLOUD_FUSIONS[fusion](tup, ta, torch.from_numpy(feats), lays, torch.from_numpy(cnt), cfg)
        _assert_semantic_close(tup, jup, fusion, f"{case} update {u}")
        assert np.count_nonzero(np.asarray(jup.semantic)[1:]) > 200
        assert not np.asarray(jup.semantic)[0].any() and not tup.semantic[0].any()  # the unowned layer
        js = js._replace(semantic=jup.semantic, sem_new=jup.sem_new, id_max=jup.id_max)
        ts = ts._replace(semantic=tup.semantic, sem_new=tup.sem_new, id_max=tup.id_max)
        pos = np.array([0.31, -0.22, 0.0], np.float32)
        js = jcore.move_to(js, jnp.asarray(pos), jnp.asarray(R_EYE), jcfg)
        ts = core.move_to(ts, torch.from_numpy(pos), torch.from_numpy(R_EYE), cfg)
        _assert_semantic_close((ts.semantic, ts.sem_new, ts.id_max), (js.semantic, js.sem_new, js.id_max),
                               fusion, f"{case} after move_to {u}")
    if case == "class_bayesian_negative_features":
        assert float(ts.sem_new.min()) >= 0.0
    if fusion == "class_max":
        assert int(ts.id_max.max()) > 0


def test_class_max_overflow_ids_are_dropped_not_miscredited():
    """More distinct ids than buckets (39 over 8): the overflow ids are
    dropped; sums and winning ids equal JAX's and the loop's over the kept
    ids (tests/test_semantic.py:247)."""
    rng = np.random.default_rng(20)
    kw = dict(CFG_KW, semantic_layers=("m1",), pointcloud_channel_fusions=(("default", "class_max"),))
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    n = cfg.cell_n
    padded, mask = _cloud(rng, 400)
    prob = rng.uniform(0.2, 1, 400).astype(np.float32)
    cls = rng.integers(1, 40, 400).astype(np.uint32)
    feats = _pad_feats(np_encode_max(prob, cls)[:, None])
    ja, ta = _shared_assoc(padded, mask, jcfg)
    jup = JF.SemanticUpdate(jnp.zeros((1, n, n)), jnp.zeros((1, n, n)), jnp.zeros((1, n, n), jnp.uint32))
    tup = F.SemanticUpdate(torch.zeros(1, n, n), torch.zeros(1, n, n), torch.zeros(1, n, n, dtype=torch.int64))
    want = JF.fuse_class_max(jup, ja, jnp.asarray(feats), [0], jnp.zeros((n, n)), jcfg, max_classes=8)
    got = F.fuse_class_max(tup, ta, torch.from_numpy(feats), [0], torch.zeros(n, n), cfg, max_classes=8)
    _assert_semantic_close(got, want, "class_max", "overflow")

    kept = np.unique(np.concatenate([cls, np.zeros(1, np.uint32)]))[:8]
    idx, pmask = np.asarray(ja.flat_idx)[:400], (np.asarray(ja.valid) & np.asarray(ja.inside))[:400]
    p16 = prob.astype(np.float16).astype(np.float64)
    best, best_id = np.zeros(n * n), np.zeros(n * n, np.uint32)
    for c in kept:
        s = np.zeros(n * n)
        sel = pmask & (cls == c)
        np.add.at(s, idx[sel], p16[sel])
        upd = s > best
        best, best_id = np.where(upd, s, best), np.where(upd, c, best_id)
    np.testing.assert_allclose(got.sem_new[0].numpy().reshape(-1), best, atol=1e-3)
    nz = best > 0
    assert nz.sum() > 50
    np.testing.assert_array_equal(got.id_max[0].numpy().reshape(-1)[nz], best_id[nz])
    assert not np.isin(got.id_max.numpy(), np.setdiff1d(np.unique(cls), kept)).any()


# ---------------------------------------------------------------------------
# dispatch and the core step
# ---------------------------------------------------------------------------

MIXED_TABLE = (("rgb", "color"), ("feat_.*", "average"), ("cls_.*", "class_bayesian"))
MIXED_CHANNELS = ("rgb", "feat_a", "unmapped", "cls_b", "cls_c")
MIXED_LAYERS = ("cls_b", "rgb", "cls_c", "feat_a")  # layer order differs from column order


def _mixed_features(rng, n, pad=4096):
    feats = np.zeros((n, 5), np.float32)
    feats[:, 0] = np_pack_rgb(rng.integers(0, 256, (n, 3)))
    feats[:, 1:] = rng.uniform(0, 1, (n, 4))
    return _pad_feats(feats, pad)


def test_update_semantic_pointcloud_mixed_channels():
    """Colour + two fusions + one channel no table entry maps (skipped):
    fusions run in sorted name order, each over its own columns and layers;
    the per-update rows of sem_new are reset, the Dirichlet rows persist."""
    rng = np.random.default_rng(30)
    kw = dict(CFG_KW, semantic_layers=MIXED_LAYERS, pointcloud_channel_fusions=MIXED_TABLE)
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    assert U.resolve_channels(MIXED_CHANNELS, cfg) == JU.resolve_channels(MIXED_CHANNELS, jcfg)
    assert [c for c, _, _ in U.resolve_channels(MIXED_CHANNELS, cfg)] == [0, 1, 3, 4]
    assert U.persistent_mask(cfg) == JU.persistent_mask(jcfg) == (True, False, True, False)
    n = cfg.cell_n
    jsem = (jnp.zeros((4, n, n)), jnp.zeros((4, n, n)), jnp.zeros((4, n, n), jnp.uint32))
    tsem = (torch.zeros(4, n, n), torch.zeros(4, n, n), torch.zeros(4, n, n, dtype=torch.int64))
    for u in range(2):
        padded, mask = _cloud(rng)
        feats = _mixed_features(rng, N_POINTS)
        ja, ta = _shared_assoc(padded, mask, jcfg)
        cnt = np.zeros(n * n, np.float32)
        np.add.at(cnt, np.asarray(ja.flat_idx)[np.asarray(ja.mask)], 1.0)
        cnt = cnt.reshape(n, n)
        jsem = JU.update_semantic_pointcloud(*jsem, ja, jnp.asarray(feats), MIXED_CHANNELS, jnp.asarray(cnt), jcfg)
        given, before = tsem, tuple(x.clone() for x in tsem)
        tsem = U.update_semantic_pointcloud(*given, ta, torch.from_numpy(feats), MIXED_CHANNELS, torch.from_numpy(cnt), cfg)
        for g, b in zip(given, before):  # the inputs were not written
            assert torch.equal(g, b)
        np.testing.assert_array_equal(_bits(tsem[0][1].numpy()), _bits(jsem[0][1]), err_msg="rgb")
        for lay in (0, 2, 3):
            np.testing.assert_allclose(tsem[0][lay].numpy(), np.asarray(jsem[0][lay]), atol=1e-4)
        np.testing.assert_allclose(tsem[1].numpy(), np.asarray(jsem[1]), atol=1e-4)
        np.testing.assert_array_equal(tsem[2].numpy().astype(np.uint32), np.asarray(jsem[2]))
    assert np.count_nonzero(np.asarray(jsem[0][1])) > 200


def test_update_semantic_pointcloud_edges():
    """No semantic layers or no channels: the inputs come back untouched. A
    channel that maps to a fusion but has no layer raises, as in JAX."""
    cfg = MapConfig(**CFG_KW)
    rng = np.random.default_rng(31)
    padded, mask = _cloud(rng)
    _, ta = _shared_assoc(padded, mask, JaxConfig(**CFG_KW))
    n = cfg.cell_n
    empty = (torch.zeros(0, n, n), torch.zeros(0, n, n), torch.zeros(0, n, n, dtype=torch.int64))
    feats = torch.zeros(4096, 1)
    out = U.update_semantic_pointcloud(*empty, ta, feats, ("grass",), torch.zeros(n, n), cfg)
    assert all(o is e for o, e in zip(out, empty))
    cfg1 = cfg.replace(semantic_layers=("grass",))
    one = (torch.zeros(1, n, n), torch.zeros(1, n, n), torch.zeros(1, n, n, dtype=torch.int64))
    out = U.update_semantic_pointcloud(*one, ta, feats[:, :0], (), torch.zeros(n, n), cfg1)
    assert all(o is e for o, e in zip(out, one))
    with pytest.raises(ValueError, match="tree"):
        U.update_semantic_pointcloud(*one, ta, feats, ("tree",), torch.zeros(n, n), cfg1)
    with pytest.raises(ValueError, match="tree"):
        JU.resolve_channels(("tree",), JaxConfig(**CFG_KW, semantic_layers=("grass",)))
    # a table with no default leaves the channel unmapped: skipped, not an error
    cfg2 = cfg1.replace(pointcloud_channel_fusions=(("rgb", "color"),))
    out = U.update_semantic_pointcloud(*one, ta, feats, ("tree",), torch.zeros(n, n), cfg2)
    assert torch.equal(out[0], one[0])


def test_core_update_pointcloud_semantic_matches_jax():
    """Two whole updates (geometry + every fusion of a mixed table, one
    association pass) with a move_to between them: every state field
    against JAX, layers at the 1e-4 of the geometric tests, packed colours
    and ids bit for bit."""
    import chip_smoke

    rng = np.random.default_rng(32)
    table = MIXED_TABLE + (("max_.*", "class_max"), ("default", "class_average"))
    channels = MIXED_CHANNELS + ("max_d",)
    layers = MIXED_LAYERS + ("unmapped", "max_d")
    kw = dict(CFG_KW, semantic_layers=layers, pointcloud_channel_fusions=table)
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    js, ts = jinit_state(jcfg), init_state(cfg, "cpu")
    jw, tw = jdefault_weights(), default_weights()
    for u in range(2):
        R, t, pos = chip_smoke.robot_pose(5 * u)
        pts = chip_smoke.scene_cloud(rng, N_POINTS, R, t, r_max=2.5)
        feats = _mixed_features(rng, N_POINTS, N_POINTS)
        enc = np_encode_max(rng.uniform(0.2, 1, N_POINTS).astype(np.float32), rng.integers(1, 6, N_POINTS).astype(np.uint32))
        cloud = np.zeros((4096, 9), np.float32)
        cloud[:N_POINTS] = np.concatenate([pts, feats, enc[:, None]], 1)
        mask = np.arange(4096) < N_POINTS
        js = jcore.move_to(js, jnp.asarray(pos), jnp.asarray(R), jcfg)
        ts = core.move_to(ts, torch.from_numpy(pos), torch.from_numpy(R), cfg)
        js = jcore.update_pointcloud_semantic(
            js, jnp.asarray(cloud), jnp.asarray(mask), jnp.asarray(R), jnp.asarray(t),
            jnp.float32(0), jnp.float32(0), jw, jcfg, channels,
        )
        ts = core.update_pointcloud_semantic(
            ts, torch.from_numpy(cloud), torch.from_numpy(mask), torch.from_numpy(R), torch.from_numpy(t),
            0.0, 0.0, tw, cfg, channels,
        )
        got = state_to_numpy(ts)
        rgb = layers.index("rgb")
        for name in js._fields:
            want = np.asarray(getattr(js, name))
            assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
            if name == "id_max":
                np.testing.assert_array_equal(got[name], want)
            elif name == "semantic":
                np.testing.assert_array_equal(_bits(got[name][rgb]), _bits(want[rgb]), err_msg="rgb layer")
                others = [i for i in range(len(layers)) if i != rgb]
                np.testing.assert_allclose(got[name][others], want[others], atol=1e-4, err_msg=name)
            else:
                np.testing.assert_allclose(got[name], want, atol=1e-3 if name == "sem_new" else 1e-4, err_msg=name)
    assert got["id_max"].max() > 0 and np.count_nonzero(got["semantic"][rgb]) > 100
    assert np.count_nonzero(got["semantic"][layers.index("unmapped")]) > 100  # the default fusion took it


def test_shift_and_clear_carry_semantic_stacks():
    """shift_map_xy and clear with S > 0 against JAX: packed colours, sums
    and ids move by whole cells, bit for bit, and the revealed cells are 0."""
    rng = np.random.default_rng(33)
    kw = dict(CFG_KW, semantic_layers=("rgb", "m"))
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    n = cfg.cell_n
    arrays = {k: np.asarray(v) for k, v in jinit_state(jcfg)._asdict().items()}
    arrays["semantic"] = np.stack([np_pack_rgb(rng.integers(0, 256, (n, n, 3))),
                                   np_encode_max(rng.uniform(0, 1, (n, n)).astype(np.float32),
                                                 rng.integers(0, 1 << 16, (n, n)).astype(np.uint32))])
    arrays["sem_new"] = rng.normal(0, 1, (2, n, n)).astype(np.float32)
    arrays["id_max"] = rng.integers(0, 1 << 32, (2, n, n), dtype=np.uint64).astype(np.uint32)
    js = type(jinit_state(jcfg))(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state_from_numpy(arrays, "cpu")
    back = state_to_numpy(ts)
    for name in ("semantic", "sem_new"):
        np.testing.assert_array_equal(_bits(back[name]), _bits(arrays[name]))
    np.testing.assert_array_equal(back["id_max"], arrays["id_max"])
    for s0, s1 in ((3, -2), (-5, 0), (0, 7)):
        js = jcore.shift_map_xy(js, jnp.asarray([s0, s1]), jcfg)
        ts = core.shift_map_xy(ts, s0, s1, cfg)
        got = state_to_numpy(ts)
        for name in ("semantic", "sem_new"):
            np.testing.assert_array_equal(_bits(got[name]), _bits(getattr(js, name)), err_msg=name)
        np.testing.assert_array_equal(got["id_max"], np.asarray(js.id_max))
    assert np.count_nonzero(got["semantic"][0]) > n * n // 2
    js, ts = jcore.clear(js, jcfg), core.clear(ts, cfg)
    got = state_to_numpy(ts)
    for name in ("semantic", "sem_new", "id_max"):
        assert not got[name].any() and got[name].shape == np.asarray(getattr(js, name)).shape
