"""The port's exact visibility cleanup (kernel K2's plain version) against JAX.

The same seeded NumPy inputs go through the JAX package's
``visibility_cleanup_exact`` (each of ``scan``, ``flat``, ``gated``), its
router and mapper, and through the port's counterparts on the CPU. The
upper bound is a min, so it must agree bit for bit; the decrement and the
variance add differ only by the order of their sums (about 1e-6 relative).
The port's copy of the recorded-fixture loop reproduces both recorded maps.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import torch_scenes
from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import core as jcore
from elevation_mapping_cupy_tpu import init_state as jinit_state
from elevation_mapping_cupy_tpu.mapper import ElevationMap as JaxMap
from elevation_mapping_cupy_tpu.nn import traversability as jtrav
from elevation_mapping_cupy_tpu.ops import geometry as jgeo
from elevation_mapping_cupy_tpu.ops import pointcloud as jpc
from elevation_mapping_cupy_tpu.ops import raycast as jrc

from elevation_mapping_cupy_torch import MapConfig, core, init_state
from elevation_mapping_cupy_torch.mapper import ElevationMap
from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE, load_weights_npz
from elevation_mapping_cupy_torch.ops import cuda_march
from elevation_mapping_cupy_torch.ops import geometry as tgeo
from elevation_mapping_cupy_torch.ops import raycast as trc

from .make_recorded_fixture import FIXTURE, FIXTURE_DEPLOYED, SEED, deployed_config, pinned_config

# small map, 29 march steps; the gated march's gate table has 4x4 blocks
CFG_KW = dict(
    resolution=0.1, map_length=3.0, max_ray_length=2.0, max_points=8192,
    raycast_mode="exact", enable_drift_compensation=False,
)
N_PTS = 6000
T3 = np.array([0.0, 0.0, 0.6], np.float32)
# decrement and variance add: summation order only (float32 sums of a few
# dozen terms per cell)
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg) -> MapConfig:
    return MapConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _scene(kind: str):
    """A JAX map with an invalid hole (upper-bound writes) aged past the
    recency gate, and a second cloud below it whose rays penetrate the
    mapped cells (hits): the fused layers and the association both
    packages start the cleanup from. ``kind`` "high" lifts every ray 50 m
    above a map whose invalid cells all hold an upper bound (the gate culls
    everything); "empty" masks every point (an empty march)."""
    rng = np.random.default_rng(3)
    jcfg = JaxConfig(**CFG_KW)
    w = jtrav.default_weights()
    R = jnp.eye(3)
    z0 = jnp.float32(0)
    state = jinit_state(jcfg)
    pts0 = rng.uniform(-1.4, 1.4, (N_PTS, 3)).astype(np.float32)
    pts0[:, 2] = rng.uniform(-0.15, 0.25, N_PTS)
    hole = (np.abs(pts0[:, 0] - 0.6) < 0.3) & (np.abs(pts0[:, 1]) < 0.3)
    pts0[hole] = 0.0
    state = jcore.update_pointcloud(
        state, jnp.asarray(pts0), jnp.asarray(~hole), R, jnp.asarray(T3), z0, z0, w, jcfg
    )
    for _ in range(7):
        state = jcore.update_time(state, jcfg)
    pts = rng.uniform(-1.4, 1.4, (N_PTS, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.6, -0.3, N_PTS)
    mask = np.ones(N_PTS, bool)
    mask[-40:] = False  # padding rows
    if kind == "empty":
        mask[:] = False
    t_c = T3 - np.asarray(state.center)
    ja = jgeo.associate_points(jnp.asarray(pts), jnp.asarray(mask), R, jnp.asarray(t_c), jcfg)
    jc = jpc.error_counting(state.layers, ja, jcfg)
    jl, _ = jpc.point_fusion(state.layers, ja, jc.point_cnt, jcfg)
    ta = tgeo.associate_points(_t(pts), _t(mask), torch.eye(3), _t(t_c), _port_cfg(jcfg))
    if kind == "high":
        # every invalid cell gets an upper bound at 0, so no cell's gate is
        # +inf and rays 50 m up can write nowhere
        fused = np.asarray(jl).copy()
        fused[5] = np.where(fused[2] < 0.5, 0.0, fused[5])
        fused[6] = np.where(fused[2] < 0.5, 1.0, fused[6])
        jl = jnp.asarray(fused)
        lift = np.array([0.0, 0.0, 50.0], np.float32)
        ja = ja._replace(world=ja.world + jnp.asarray(lift))
        ta = ta._replace(world=ta.world + _t(lift))
        t_c = t_c + lift
    jargs = (jl, state.normal, ja, jc.inlier_cnt, jnp.asarray(t_c))
    targs = (_t(jl), _t(state.normal), ta, _t(jc.inlier_cnt), _t(t_c))
    return jcfg, jargs, targs


@pytest.fixture(scope="module")
def rich():
    return _scene("rich")


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even (exact)."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(np.array(c).view(np.int32)) & 1))


def test_fma32_and_sqrt32_round_once():
    """The port's float32 FMA and square root, the two operations whose
    rounding the exact march must share with XLA:CPU, against exact
    rational arithmetic: random operands, and operands whose exact result
    lies just off a float32 tie, where rounding through float64 twice
    goes wrong."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 300).astype(np.float32)
    b = rng.normal(0, 3, 300).astype(np.float32)
    c = rng.normal(0, 2, 300).astype(np.float32)
    a[:4] = np.float32(1 + 2.0**-18)
    b[:4] = np.float32(2.0**-24 * (1 - 2.0**-18)) * np.array([1, -1, 1, -1], np.float32)
    c[:4] = np.array([1 + 2.0**-23, -(1 + 2.0**-23), 3 * (1 + 2.0**-23), 1.0], np.float32)
    want = np.array([_rn32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))) for x, y, z in zip(a, b, c)])
    got = tgeo.fma32(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (a[:2].astype(np.float64) * b[:2] + c[:2]).astype(np.float32).tolist() != want[:2].tolist()

    x = np.concatenate([rng.uniform(0, 5, 4000), rng.uniform(0, 1e-3, 1000), [0.0, 1e-45, 4.0]]).astype(np.float32)
    np.testing.assert_array_equal(tgeo.sqrt32(_t(x)).numpy(), np.sqrt(x))  # numpy's is correctly rounded


def test_ray_table_matches_jax(rich):
    """Directions, decrements and live-step counts as ``_exact_flat``
    computes them (raycast.py:382-400), bit for bit: the same float32
    compares decide where each ray's march ends. The count is the flat
    march's, cut by the endpoint test, for every implementation."""
    jcfg, jargs, targs = rich
    _, _, ja, _, t_c = jargs
    cfg = _port_cfg(jcfg)
    p = ja.world
    vvec = p - t_c
    norm = jnp.linalg.norm(vvec, axis=-1)
    rdir = jnp.where(norm[:, None] > 0, vvec / jnp.maximum(norm, 1e-30)[:, None], 0.0)
    ray_length = jnp.minimum(norm, jcfg.max_ray_length)
    dec_amount = jcfg.cleanup_step / (ray_length / jcfg.max_ray_length)
    step = jnp.asarray(jcfg.ray_step, jnp.float32)
    steps = jnp.arange(1, jcfg.n_ray_steps + 1, dtype=jnp.float32) * step
    k1 = jnp.searchsorted(steps, ray_length, side="left")
    k2 = jnp.searchsorted(steps, norm - jnp.sqrt(jnp.asarray(0.1, jnp.float32)) + step, side="right")
    rays, k = cuda_march.ray_table(targs[2].world, targs[2].valid, targs[4], cfg)
    valid = np.asarray(ja.valid)
    np.testing.assert_array_equal(k.numpy(), np.where(valid, np.asarray(jnp.minimum(k1, k2)), 0))
    np.testing.assert_array_equal(rays[:3].numpy().T[valid], np.asarray(rdir)[valid])
    np.testing.assert_array_equal(rays[3:6].numpy().T, np.asarray(p))
    np.testing.assert_array_equal(rays[6].numpy()[valid], np.asarray(dec_amount)[valid])
    np.testing.assert_array_equal(cuda_march.ray_steps(cfg, "cpu").numpy(), np.asarray(steps))
    assert int(k.sum()) > 10 * N_PTS
    assert int(k.sum()) < int(np.where(valid, np.asarray(k1), 0).sum())  # the cut drops steps


@pytest.mark.parametrize("impl", ["scan", "flat", "gated"])
def test_exact_cleanup_matches_jax(rich, impl):
    jcfg, jargs, targs = rich
    jcfg = jcfg.replace(raycast_exact_impl=impl)
    want, jaux = jrc.visibility_cleanup_exact(*jargs, jcfg, with_aux=True)
    got, taux = trc.visibility_cleanup_exact(*targs, _port_cfg(jcfg), with_aux=True)
    want, got, base = np.asarray(want), got.numpy(), np.asarray(jargs[0])
    dec = base[2] - want[2]
    assert (dec > 0).sum() > 100, "the scene must clean cells up"
    assert (want[6] > base[6]).sum() > 50, "the scene must write upper bounds"
    np.testing.assert_allclose(base[2] - got[2], dec, rtol=SUM_RTOL, atol=1e-7)
    np.testing.assert_allclose(got[1] - base[1], want[1] - base[1], rtol=SUM_RTOL, atol=1e-7)
    for layer in (0, 3, 4, 5, 6):  # untouched, and the order-free upper bound
        np.testing.assert_array_equal(got[layer], want[layer], err_msg=f"layer {layer}")
    assert float(taux["gate_survivor_frac"]) == float(jaux["gate_survivor_frac"])


@pytest.mark.parametrize("kind", ["rich", "high", "empty"])
def test_gated_survivor_fraction_matches_jax(kind):
    """The router's signal, equal to JAX's: segments that pass the gate
    over live segments, 0 when every ray passes high above the map's
    writable heights, 0.0 on an empty march."""
    jcfg, jargs, targs = _scene(kind)
    jcfg = jcfg.replace(raycast_exact_impl="gated")
    want, jfrac = jrc._exact_gated(*jargs, jcfg)
    got, aux = trc.visibility_cleanup_exact(*targs, _port_cfg(jcfg), with_aux=True)
    frac = float(aux["gate_survivor_frac"])
    assert frac == float(jfrac)
    assert {"rich": 0.3 < frac <= 1.0, "high": frac < 0.01, "empty": frac == 0.0}[kind], frac
    np.testing.assert_array_equal(got.numpy()[5], np.asarray(want)[5])


def test_exact_march_wrapper_on_the_cpu(rich):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch. A gate that passes everything changes nothing; one that passes
    nothing writes nothing. The work tally counts what the march did."""
    jcfg, _, targs = rich
    cfg = _port_cfg(jcfg)
    layers, normal, assoc, inlier, t = targs
    pack = trc.exact_precompute(layers, normal, inlier, cfg)
    assert pack.shape == (cfg.cell_n**2, cuda_march.PACK_WIDTH) and float(pack[:, 7].abs().max()) == 0
    args = (pack, assoc.world, assoc.valid, t, cfg)
    _, k = cuda_march.ray_table(assoc.world, assoc.valid, t, cfg)
    before = cuda_march.KERNEL.launches
    free = cuda_march.exact_march(*args)
    assert cuda_march.KERNEL.launches == before and free.counts is None
    assert torch.equal(free.hits, torch.round(free.hits)) and float(free.hits.sum()) > 0
    assert bool(torch.isinf(free.ubmin).any()) and bool(torch.isfinite(free.ubmin).any())
    work = {}
    cuda_march.exact_march_reference(*args, work=work)
    assert work["rays"] == int(assoc.valid.sum()) and work["walked"] == int(k.sum())
    assert work["walked"] > work["fresh"] > work["tested"] >= work["eligible"] >= work["penetrating"]
    assert work["hits"] == int(free.hits.sum()) > 0 and work["ub_writes"] > 0

    gate = trc.exact_gate(pack, cfg)
    n_seg = int(((k + gate.seg - 1) // gate.seg).sum())
    open_gate = gate._replace(table=torch.full_like(gate.table, np.inf))
    res = cuda_march.exact_march(*args, open_gate)
    assert res.counts.tolist() == [n_seg, n_seg]
    assert torch.equal(res.hits, free.hits) and torch.equal(res.ubmin, free.ubmin)
    torch.testing.assert_close(res.dec, free.dec, rtol=SUM_RTOL, atol=1e-7)
    shut_gate = gate._replace(table=torch.full_like(gate.table, -np.inf))
    shut = cuda_march.exact_march(*args, shut_gate)
    assert shut.counts.tolist() == [0, n_seg]
    assert float(shut.hits.sum()) == 0 and bool(torch.isinf(shut.ubmin).all())
    work = {}
    cuda_march.exact_march_reference(*args, shut_gate, work=work)
    assert work["segments"] == n_seg and work["walked"] == work["fresh"] == 0

    with pytest.raises(TypeError):
        cuda_march.exact_march(pack, assoc.world, assoc.valid.int(), t, cfg)
    with pytest.raises(ValueError):
        cuda_march.exact_march(pack[:, :-1], assoc.world, assoc.valid, t, cfg)


def test_exact_dispatch_aux_and_dtype_guard(rich):
    jcfg, _, targs = rich
    cfg = _port_cfg(jcfg)
    layers = targs[0]
    for kw in (dict(raycast_exact_impl="scan"), dict(raycast_mode="polar"), dict(enable_visibility_cleanup=False)):
        out, aux = trc.visibility_cleanup(*targs, cfg.replace(**kw), with_aux=True)
        assert float(aux["gate_survivor_frac"]) == 1.0 and out.shape == layers.shape
    assert trc.visibility_cleanup(*targs, cfg.replace(enable_visibility_cleanup=False)) is layers
    with pytest.raises(ValueError, match="raycast_exact_impl"):
        trc.visibility_cleanup(*targs, cfg.replace(raycast_exact_impl="dense"))
    # flat and gated need 32-bit layers, as in the JAX package; the scan does not
    args64 = (layers.double(), targs[1].double(), targs[2], targs[3], targs[4].double())
    for impl in ("flat", "gated"):
        with pytest.raises(TypeError, match="32-bit"):
            trc.visibility_cleanup_exact(*args64, cfg.replace(raycast_exact_impl=impl))
    a64 = args64[2]._replace(world=args64[2].world.double())
    out64 = trc.visibility_cleanup_exact(*args64[:2], a64, *args64[3:], cfg.replace(raycast_exact_impl="scan"))
    assert out64.dtype == torch.float64 and bool(torch.isfinite(out64).all())
    assert trc.resolve_exact_impl(cfg) == "scan"  # 29 * 8192 < 1 << 20
    assert trc.resolve_exact_impl(cfg.replace(max_ray_length=10.0)) == "gated"


def test_router_policy_matches_jax():
    """The port's AdaptiveExactRouter mirrors tests/test_raycast_modes.py's
    policy test, and routes exactly as the JAX router does on the same
    observations."""
    kw = dict(resolution=0.05, map_length=4.0, max_ray_length=10.0, max_points=8192, raycast_mode="exact")
    r = trc.AdaptiveExactRouter(MapConfig(**kw), threshold=0.8, probe_period=4)
    assert r.route() == "gated"
    r.observe("gated", 0.95)
    seq = []
    for _ in range(9):
        impl = r.route()
        seq.append(impl)
        r.observe(impl, 0.95 if impl == "gated" else 1.0)
    assert seq == ["flat", "gated", "flat", "flat", "gated", "flat", "flat", "flat", "gated"]
    r.observe("gated", 0.1)
    assert r.route() == "gated"
    r.observe("gated", 0.95)
    assert [r.route() for _ in range(2)] == ["flat", "gated"]
    assert trc.AdaptiveExactRouter(MapConfig()).route() is None     # auto -> polar
    assert trc.AdaptiveExactRouter(MapConfig(**dict(kw, max_points=64))).route() is None  # scan

    fracs = np.random.default_rng(4).choice([0.05, 0.5, 0.79, 0.8, 0.95, 1.0], 60)
    routers = [trc.AdaptiveExactRouter(MapConfig(**kw)), jrc.AdaptiveExactRouter(JaxConfig(**kw))]
    routes = [[], []]
    for f in fracs:
        for r, out in zip(routers, routes):
            impl = r.route()
            out.append(impl)
            r.observe(impl, torch.tensor(f, dtype=torch.float32) if r is routers[0] else jnp.float32(f))
    assert routes[0] == routes[1]
    assert {"flat", "gated"} <= set(routes[0])


def test_mapper_routing_matches_jax():
    """A short drive through both mappers with routing live (141 steps x
    8192 points >= 1 << 20): the same gated/flat choices, and maps within
    the summation-order tolerance."""
    kw = dict(resolution=0.1, map_length=3.0, max_ray_length=10.0, max_points=8192,
              raycast_mode="exact", enable_drift_compensation=False)
    jem, tem = JaxMap(JaxConfig(**kw)), ElevationMap(MapConfig(**kw), device="cpu")
    assert tem._exact_router._eligible and jem._exact_router._eligible
    routes = {id(jem): [], id(tem): []}
    for em in (jem, tem):
        route = em._exact_router.route

        def logged(route=route, log=routes[id(em)]):
            log.append(route())
            return log[-1]

        em._exact_router.route = logged
    rng = np.random.default_rng(21)
    for k in range(4):
        R, t, pos = torch_scenes.robot_pose(3 * k)
        pts = torch_scenes.scene_cloud(rng, 3000, R, t, r_max=2.0)
        for em in (jem, tem):
            em.move_to(pos, R)
            em.input_pointcloud(pts, ["x", "y", "z"], R, t, 0.0, 0.0)
            em.update_time()
    assert routes[id(tem)] == routes[id(jem)]
    assert routes[id(tem)][:2] == ["gated", "flat"]  # the empty map's gate culls nothing
    assert float(tem._exact_router._last_frac) == pytest.approx(float(jem._exact_router._last_frac), abs=1e-6)
    names = ["elevation", "variance", "is_valid", "traversability", "upper_bound", "is_upper_bound"]
    want, got = jem.get_layers(names), tem.get_layers(names)
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=SUM_RTOL, atol=1e-5, err_msg=name)


def test_warm_raycast_impls():
    kw = dict(resolution=0.1, map_length=3.0, max_ray_length=10.0, max_points=8192, raycast_mode="exact")
    em = ElevationMap(MapConfig(**kw), device="cpu")
    before = em.state.layers.clone()
    assert em.warm_raycast_impls(2000) == ["gated", "flat"]
    assert torch.equal(em.state.layers, before)
    assert ElevationMap(MapConfig(), device="cpu").warm_raycast_impls() == []


def _run_pinned(cfg: MapConfig):
    """The port's copy of tests/make_recorded_fixture.py::run_pinned's loop."""
    weights = load_weights_npz(DEFAULT_WEIGHT_FILE)
    rng = np.random.default_rng(SEED)
    state = init_state(cfg, "cpu")
    R = torch.eye(3)
    for it in range(3):
        pts = rng.uniform(-1.2, 1.2, size=(1500, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-0.1, 0.4, size=1500).astype(np.float32)
        t = torch.tensor([0.1 * it, -0.05 * it, 0.5], dtype=torch.float32)
        padded = np.zeros((cfg.max_points, 3), np.float32)
        padded[: len(pts)] = pts
        mask = np.zeros(cfg.max_points, bool)
        mask[: len(pts)] = True
        state = core.update_pointcloud(
            state, _t(padded), _t(mask), R, t, 0.2, 0.0, weights, cfg,
        )
        state = core.update_time(state, cfg)
        state = core.update_variance(state, cfg)
    return state.layers.numpy(), state.normal.numpy()


@pytest.mark.parametrize(
    "fixture,impl",
    [("v1", "auto"), ("deployed", "auto"), ("deployed", "flat"), ("deployed", "gated")],
)
def test_recorded_fixture_reproduced(fixture, impl):
    """Both recorded maps (JAX, exact march, CPU) reproduced by the port
    at the JAX test's atol of 1e-5; "auto" resolves to the scan there."""
    path, factory = {"v1": (FIXTURE, pinned_config), "deployed": (FIXTURE_DEPLOYED, deployed_config)}[fixture]
    cfg = _port_cfg(factory()).replace(raycast_exact_impl=impl)
    assert trc.resolve_raycast_mode(cfg) == "exact"
    rec = np.load(path)
    layers, normal = _run_pinned(cfg)
    np.testing.assert_allclose(layers, rec["layers"], atol=1e-5)
    np.testing.assert_allclose(normal, rec["normal"], atol=1e-5)
