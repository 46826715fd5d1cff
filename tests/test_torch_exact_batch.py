"""The exact visibility cleanup over a batch of maps, on the CPU (K2's plain
version): one march for every map of a batched update, each map's result
that of its own update, and the dense per-ray march of the benchmark's
plain reference (``benchmark/reference/exact.py``) giving the same map.

The scene is a small map (62 x 62 cells at 0.05 m, 2 m rays of 56 steps):
a step of ground points everywhere, the map aged past the recency gate,
a step of ground points seen again (the gate culls most segments), and a
low sweep whose rays pass under the mapped cells (hits and upper bounds).
Each map has its own sensor position and seeded cloud; the CNN's weights
are seeded too.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch import MapConfig, core, kernels
from elevation_mapping_cupy_torch.nn.traversability import TravFilter
from elevation_mapping_cupy_torch.ops import cuda_march, raycast
from elevation_mapping_cupy_torch.ops.geometry import Block, associate_points
from elevation_mapping_cupy_torch.parallel import init_batch
from elevation_mapping_cupy_torch.state import take_map

KW = dict(resolution=0.05, map_length=3.0, max_ray_length=2.0, max_points=16384, raycast_mode="exact")
B, N = 3, 16384
# ground, ground again after aging, then the low sweep: (z range, half side)
STEPS = ((0.0, 0.15, 1.45), (0.0, 0.15, 1.45), (-0.45, -0.35, 1.2))


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _weight_arrays(seed=5):
    rng = np.random.default_rng(seed)
    shapes = (("w1", (4, 1, 3, 3)), ("w2", (4, 1, 3, 3)), ("w3", (4, 1, 3, 3)), ("w_out", (1, 12, 1, 1)))
    return {k: rng.normal(0.0, 0.3, s).astype(np.float32) for k, s in shapes}


def _step_inputs(rng, z_lo, z_hi, half):
    """(points, mask, R, t, noise): each map's sensor 0.6 m up near the
    centre, its points uniform over a square, in the sensor's frame."""
    t = np.tile(np.array([0.0, 0.0, 0.6], np.float32), (B, 1))
    t[:, :2] = rng.uniform(-0.1, 0.1, (B, 2))
    pts = np.stack([rng.uniform(-half, half, (B, N)), rng.uniform(-half, half, (B, N)),
                    rng.uniform(z_lo, z_hi, (B, N))], -1).astype(np.float32)
    pts -= t[:, None, :]
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    return [torch.from_numpy(x) for x in (pts, np.ones((B, N), bool), R, t, np.zeros(B, np.float32))]


def _episode(cfg, seed=0, edit=None):
    """Batched steps, each also taken map by map from the same states, each
    compared (``_assert_maps_equal``). ``edit(step, states, inputs)`` may
    change the states and inputs before a step. Returns (the last states,
    per step the batch's survivor fractions and the maps' own, the K2
    wrapper's calls per batched step)."""
    rng = np.random.default_rng(seed)
    w = TravFilter(**_weight_arrays())
    states = init_batch(cfg, B, "cpu")
    auxes, calls = [], []
    real = cuda_march.exact_march

    def counting(*args, **kw):
        calls[-1] += 1
        return real(*args, **kw)

    for step, spec in enumerate(STEPS):
        inputs = _step_inputs(rng, *spec)
        if edit is not None:
            states, inputs = edit(step, states, inputs)
        pts, mask, R, t, z = inputs
        outs = [core.update_pointcloud_aux(take_map(states, b), pts[b], mask[b], R[b], t[b], 0.0, 0.0, w, cfg)
                for b in range(B)]
        calls.append(0)
        cuda_march.exact_march = counting
        try:
            states, aux = core.update_batch_aux(states, pts, mask, R, t, z, z, w, cfg)
        finally:
            cuda_march.exact_march = real
        _assert_maps_equal(states, [o[0] for o in outs])
        auxes.append((aux["gate_survivor_frac"], torch.stack([o[1]["gate_survivor_frac"] for o in outs])))
        if step == 0:  # aged past the recency gate, so that cells can be hit
            for _ in range(6):
                states = core.update_time(states, cfg)
    return states, auxes, calls


def _assert_maps_equal(states, singles):
    """Every field bit for bit, but the traversability layer within 1e-6:
    the CNN's convolution sums a batch of maps in another order than one
    map (the cleanup itself is bit for bit)."""
    for b in range(B):
        for name, x, y in zip(states._fields, take_map(states, b), singles[b]):
            if name == "layers":
                keep = [0, 1, 2, 4, 5, 6]
                assert torch.equal(x[keep], y[keep]), f"map {b} layers"
                assert float((x[3] - y[3]).abs().max()) <= 1e-6, f"map {b} traversability"
            else:
                assert torch.equal(x, y), f"map {b} {name}"


@pytest.mark.parametrize("impl", ["gated", "flat", "scan"])
def test_batched_exact_update_equals_per_map_updates(impl):
    """Three batched steps of 3 maps against each map's own update: one
    march a step, the maps equal, one survivor fraction a map (the gated
    march's, equal to the map's own)."""
    cfg = MapConfig(**KW, raycast_exact_impl=impl)
    states, auxes, calls = _episode(cfg)
    assert calls == [1, 1, 1]
    for frac, own in auxes:
        assert frac.shape == (B,)
        assert torch.equal(frac, own)
    if impl == "gated":
        seen_again = auxes[1][0]
        assert bool((seen_again < 0.5).all()) and len(set(seen_again.tolist())) == B
    else:
        assert all(bool((frac == 1.0).all()) for frac, _ in auxes)
    assert float((states.layers[:, 6] > 0.5).float().mean()) > 0.01


def _edit_empty_and_masked(step, states, inputs):
    """Before the sweep: map 2 fresh (every cell invalid) and map 1's rays
    all masked."""
    if step == 2:
        fresh = init_batch(MapConfig(**KW), 1, "cpu")
        states = states._replace(**{f: torch.cat([getattr(states, f)[:2], getattr(fresh, f)])
                                    for f in ("layers", "normal", "mean_error", "additive_mean_error")})
        inputs[1] = inputs[1].clone()
        inputs[1][1] = False
    return states, inputs


def test_an_empty_map_and_a_map_without_valid_rays_in_the_batch():
    """Map 1's rays all masked and map 2 fresh in the sweep's batch: the
    maps still equal their own updates; map 1 marches no segment (fraction
    0.0), and map 2, fresh, is mapped by the sweep alone."""
    states, auxes, calls = _episode(MapConfig(**KW, raycast_exact_impl="gated"), seed=1,
                                    edit=_edit_empty_and_masked)
    assert calls == [1, 1, 1]
    frac = auxes[2][0]
    assert float(frac[1]) == 0.0 and 0.0 < float(frac[0]) < 1.0 and 0.0 < float(frac[2])
    assert float((states.layers[2, 2] > 0.5).float().mean()) > 0.3


def _march_inputs(seed=3):
    """K2's inputs at B = 3 as the exact cleanup builds them, from the maps
    of two batched steps (aged), and the rays of a low sweep."""
    cfg = MapConfig(**KW, raycast_exact_impl="gated")
    rng = np.random.default_rng(seed)
    w = TravFilter(**_weight_arrays())
    states = init_batch(cfg, B, "cpu")
    for spec in STEPS[:2]:
        pts, mask, R, t, z = _step_inputs(rng, *spec)
        states, _ = core.update_batch_aux(states, pts, mask, R, t, z, z, w, cfg)
        for _ in range(3):
            states = core.update_time(states, cfg)
    pts, mask, R, t, _ = _step_inputs(rng, *STEPS[2])
    mask[1, ::2] = False
    t_c = t - states.center
    assoc = associate_points(pts, mask, R, t_c, cfg)
    inlier = torch.zeros_like(states.layers[:, 0])
    return cfg, states, assoc, inlier, t_c


def test_batched_pack_gate_and_march_equal_each_maps_own():
    """The pack, the gate table and the march of a batch are each map's own
    (the march bit for bit, its segment counts one pair a map), on the whole
    map and on a block."""
    cfg, states, assoc, inlier, t = _march_inputs()
    n = cfg.cell_n
    for blk in (None, Block(20, 5, 30, 50, n, n)):
        sl = (slice(None), slice(None)) if blk is None else (slice(blk.r0, blk.r0 + blk.h), slice(blk.c0, blk.c0 + blk.w))
        layers, normal = states.layers[..., sl[0], sl[1]], states.normal[..., sl[0], sl[1]]
        pack = raycast.exact_precompute(layers, normal, inlier[..., sl[0], sl[1]], cfg)
        gate = raycast.exact_gate(pack, cfg, blk)
        got = cuda_march.exact_march(pack, assoc.world, assoc.valid, t, cfg, gate, blk)
        n2 = pack.shape[1]
        assert got.dec.shape == (B, n2) and got.counts.shape == (B, 2)
        for b in range(B):
            own_pack = raycast.exact_precompute(layers[b], normal[b], inlier[b, sl[0], sl[1]], cfg)
            own_gate = raycast.exact_gate(own_pack, cfg, blk)
            assert torch.equal(pack[b], own_pack) and torch.equal(gate.table[b], own_gate.table)
            assert gate.origin == own_gate.origin
            own = cuda_march.exact_march(own_pack, assoc.world[b], assoc.valid[b], t[b], cfg, own_gate, blk)
            for name, x, y in zip(got._fields, got, own):
                assert torch.equal(x[b], y), f"map {b} {name}"
        assert float(got.hits.sum()) > 0 and bool(torch.isfinite(got.ubmin).any())
        assert bool((got.counts[:, 0] < got.counts[:, 1]).all())


def test_batched_march_equals_the_dense_reference():
    """The program's gated march of a batch against the benchmark's dense
    per-ray march (no gate, every step of every ray): hit counts and upper
    bounds equal, the decrement within 1e-6 relative to max(1, |sum|) (the
    two add a cell's decrements in another order)."""
    from benchmark.reference import exact as E
    from benchmark.reference.params import Params

    cfg, states, assoc, inlier, t = _march_inputs()
    pack = raycast.exact_precompute(states.layers, states.normal, inlier, cfg)
    got = cuda_march.exact_march(pack, assoc.world, assoc.valid, t, cfg, raycast.exact_gate(pack, cfg))
    dec, hits, ubmin = E.march(states.layers, states.normal, inlier, assoc.world, assoc.valid, t,
                               Params(dataclasses.asdict(cfg)))
    assert torch.equal(got.hits, hits) and torch.equal(got.ubmin, ubmin)
    assert float(((got.dec - dec).abs() / dec.abs().clamp(min=1.0)).max()) <= 1e-6
    assert float(hits.sum()) > 0 and bool(torch.isfinite(ubmin).any())
    assert float(hits[1].sum()) > 0  # the half-masked map too


def test_batched_exact_episode_matches_the_reference_update():
    """Three batched steps of the program against the benchmark's reference
    update with the dense march: every field of every map within the
    benchmark's comparison tolerance (1e-4 of max(1, |reference|))."""
    from benchmark.reference import exact as E
    from benchmark.reference import update as U
    from benchmark.reference.params import Params

    cfg = MapConfig(**KW)
    p = Params(dataclasses.asdict(cfg))
    assert p.cleanup_mode() == "exact" and raycast.resolve_exact_impl(cfg) == "scan"
    arrays = _weight_arrays()
    w, rw = TravFilter(**arrays), U.Weights.from_arrays(arrays, "cpu")
    rng = np.random.default_rng(2)
    states, ref = init_batch(cfg, B, "cpu"), U.fresh(p, B, "cpu")
    for step, spec in enumerate(STEPS):
        pts, mask, R, t, z = _step_inputs(rng, *spec)
        states, _ = core.update_batch_aux(states, pts, mask, R, t, z, z, w, cfg)
        ref = E.update(ref, pts, mask, R, t, z, z, rw, p)
        if step == 0:
            for _ in range(6):
                states = core.update_time(states, cfg)
                ref = U.update_time(ref, p)
    want = torch.cat([ref.layers, ref.normal], dim=1)
    got = torch.cat([states.layers, states.normal], dim=1)
    close = (got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)
    assert bool((close | (got.isnan() & want.isnan())).all())
    assert torch.equal(states.center, ref.center)
    assert float((ref.layers[:, 6] > 0.5).float().mean()) > 0.01


def test_wrapper_refuses_mismatched_batches_and_marches_nothing_without_rays():
    cfg, states, assoc, inlier, t = _march_inputs()
    pack = raycast.exact_precompute(states.layers, states.normal, inlier, cfg)
    gate = raycast.exact_gate(pack, cfg)
    with pytest.raises(ValueError, match="world must be"):
        cuda_march.exact_march(pack, assoc.world[:2], assoc.valid[:2], t, cfg, gate)
    with pytest.raises(ValueError, match="t must be"):
        cuda_march.exact_march(pack, assoc.world, assoc.valid, t[0], cfg, gate)
    with pytest.raises(ValueError, match="gate table"):
        cuda_march.exact_march(pack, assoc.world, assoc.valid, t, cfg, gate._replace(table=gate.table[0]))
    before = cuda_march.KERNEL.launches
    empty = cuda_march.exact_march(pack, assoc.world[:, :0], assoc.valid[:, :0], t, cfg, gate)
    assert cuda_march.KERNEL.launches == before
    assert empty.counts.tolist() == [[0, 0]] * B and float(empty.hits.abs().sum()) == 0.0
    assert bool(torch.isinf(empty.ubmin).all()) and empty.ubmin.shape == (B, cfg.cell_n**2)


def test_one_launch_cleanup_refuses_what_its_kernel_cannot_take():
    """``cuda_march.exact_cleanup`` (the whole cleanup of whole maps in K2's
    one launch) runs only on the card: CPU tensors, a gate table handed in
    (the kernel builds its own), maps of another size and other dtypes are
    refused before any build; on the CPU the cleanup is composed of its
    plain parts, with no launch."""
    cfg, states, assoc, inlier, t = _march_inputs()
    spec = cuda_march.Gate(None, raycast._GATE_SEG, raycast._GATE_BLOCK, raycast._GATE_EPS)
    args = (states.layers, states.normal, inlier, assoc.world, assoc.valid, t, cfg)
    with pytest.raises(ValueError, match="runs on the card"):
        cuda_march.exact_cleanup(*args, spec)
    with pytest.raises(ValueError, match="builds the gate table itself"):
        cuda_march.exact_cleanup(*args, spec._replace(table=torch.zeros(B, 2, 2)))
    with pytest.raises(ValueError, match="the cleanup takes"):
        cuda_march.exact_cleanup(args[0][:, :, 1:], *args[1:], spec)
    with pytest.raises(TypeError, match="float32 layers"):
        cuda_march.exact_cleanup(args[0].double(), *args[1:], spec)
    before = cuda_march.KERNEL.launches
    out, aux = raycast.visibility_cleanup_exact(states.layers, states.normal, assoc, inlier, t, cfg, with_aux=True)
    assert cuda_march.KERNEL.launches == before and out.shape == states.layers.shape
    assert aux["gate_survivor_frac"].shape == (B,)


def test_exact_march_entry_point_takes_the_wrappers_arguments():
    """The C entry point's parameters are KERNEL's argument types (the map
    count before the rays a map), the stream last."""
    with open(os.path.join(kernels.CSRC_DIR, "exact_march.cu")) as f:
        src = f.read()
    params = re.search(r'extern "C" int exact_march\((.*?)\)', src, re.S).group(1).split(",")
    types = [p.strip().rsplit(" ", 1)[0] for p in params]
    ctype = {"const void*": "c_void_p", "void*": "c_void_p", "int32_t": "c_int", "int64_t": "c_long",
             "float": "c_float"}
    assert types[6:8] == ["int32_t", "int64_t"] and types[-1] == "void*"
    assert [ctype[x] for x in types] == [a.__name__ for a in cuda_march.KERNEL.argtypes]


@pytest.mark.parametrize("off", [dict(enable_visibility_cleanup=False), dict(max_ray_length=0.0)])
def test_an_unknown_exact_implementation_raises_with_the_cleanup_off(off):
    """The implementation is resolved before the cleanup's early return, so
    a misspelt one is refused in every configuration."""
    cfg, states, assoc, inlier, t_c = _march_inputs()
    cfg = dataclasses.replace(cfg, raycast_exact_impl="bogus", **off)
    with pytest.raises(ValueError, match="unknown raycast_exact_impl"):
        raycast.visibility_cleanup_exact(states.layers, states.normal, assoc, inlier, t_c, cfg)
