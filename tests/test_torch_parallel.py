"""The port's batched multi-map engine against ``elevation_mapping_cupy_tpu.parallel``.

Both packages get the same seeded NumPy inputs at ``tests/test_parallel.py``'s
config (0.1 m cells, a 2 m map, 0.5 m rays, 512 points) and B = 3 to 4 maps;
the port runs on the CPU (its kernels' plain versions). Also: the port's
batched update against its own per-map loop, K1's launch count per batched
step, checkpoints, the single-process distributed helpers, and a two-process
gloo run (this file is its own worker: ``python test_torch_parallel.py PORT
RANK WORLD``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the two-process worker runs this file as a script
    sys.path.insert(0, REPO)

from elevation_mapping_cupy_torch import MapConfig, core  # noqa: E402
from elevation_mapping_cupy_torch.nn.traversability import default_weights, load_weights_npz  # noqa: E402
from elevation_mapping_cupy_torch.ops import cuda_scatter  # noqa: E402
from elevation_mapping_cupy_torch.parallel import (  # noqa: E402
    batch_stats,
    batched_input_image,
    batched_move_to,
    batched_update,
    checkpoint,
    distributed,
    init_batch,
    make_mesh,
    shard_states,
)
from elevation_mapping_cupy_torch.state import (  # noqa: E402
    init_state,
    stack_maps,
    state_from_numpy,
    state_to_numpy,
    take_map,
)

CFG_KW = dict(resolution=0.1, map_length=2.0, max_ray_length=0.5, max_points=512)
CFG = MapConfig(**CFG_KW)  # "auto" resolves to the exact march at this size
POLAR_KW = dict(CFG_KW, raycast_mode="polar")
WORKER_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def make_batch_inputs(rng, B, n, moving=False):
    """test_parallel.py's inputs; ``moving`` gives each map its own sensor
    position and pose noise (so the drift gate differs between maps)."""
    pts = rng.uniform(-0.9, 0.9, (B, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-0.1, 0.3, (B, n)).astype(np.float32)
    mask = np.ones((B, n), bool)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    t = np.tile(np.array([0, 0, 0.5], np.float32), (B, 1))
    z = np.zeros((B,), np.float32)
    if moving:
        t[:, :2] = rng.uniform(-0.15, 0.15, (B, 2))
        mask[:, -40:] = False
        z = np.where(np.arange(B) % 2 == 0, 0.05, 0.0).astype(np.float32)
    return pts, mask, R, t, z


def _jax():
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
    from elevation_mapping_cupy_tpu import parallel as jpar
    from elevation_mapping_cupy_tpu.nn import traversability as jtrav

    return jnp, JaxConfig, jpar, jtrav


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_batches_close(t_states, j_states, atol, fields=None):
    got = state_to_numpy(t_states)
    for name in fields or got:
        want = np.asarray(getattr(j_states, name))
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(got[name], want, atol=atol, err_msg=name)


def _weights_pair():
    """The shipped CNN weights in both packages (non-trivial traversability)."""
    from elevation_mapping_cupy_tpu.nn import traversability as jtrav
    from elevation_mapping_cupy_torch.nn.traversability import DEFAULT_WEIGHT_FILE

    return jtrav.load_weights_npz(DEFAULT_WEIGHT_FILE), load_weights_npz(DEFAULT_WEIGHT_FILE)


def test_init_batch_shapes_and_dtypes():
    jnp, JaxConfig, jpar, _ = _jax()
    for kw in (CFG_KW, dict(CFG_KW, semantic_layers=("rgb", "grass"))):
        got = init_batch(MapConfig(**kw), 3, device="cpu")
        want = jpar.init_batch(JaxConfig(**kw), 3)
        for name, leaf in zip(got._fields, got):
            ref = np.asarray(getattr(want, name))
            assert tuple(leaf.shape) == ref.shape, name
            assert leaf.device.type == "cpu"
            assert leaf.dtype == (torch.int64 if name == "id_max" else torch.float32), name
            np.testing.assert_array_equal(leaf.numpy(), ref.astype(leaf.numpy().dtype), err_msg=name)
    # the maps are independent tensors, not views of one
    states = init_batch(CFG, 2, device="cpu")
    states.layers[0, 0] += 1.0
    assert float(states.layers[1, 0].abs().max()) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_batch(CFG, 2)


def test_stack_and_take_maps_round_trip():
    states = [init_state(CFG, "cpu") for _ in range(3)]
    states[1] = states[1]._replace(layers=states[1].layers + 1.0)
    batch = stack_maps(states)
    assert batch.layers.shape == (3, 7, CFG.cell_n, CFG.cell_n)
    for b in range(3):
        for x, y in zip(take_map(batch, b), states[b]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kw,shipped_weights", [(CFG_KW, False), (POLAR_KW, False), (POLAR_KW, True)],
                         ids=["auto-exact", "polar", "polar-shipped-weights"])
def test_batched_update_matches_jax(rng, kw, shipped_weights):
    """B = 4 maps, two steps with per-map sensor positions and drift gates:
    every field within 1e-5 of JAX's batched_update."""
    jnp, JaxConfig, jpar, jtrav = _jax()
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    jw, tw = _weights_pair() if shipped_weights else (jtrav.default_weights(), default_weights())
    B = 4
    js, ts = jpar.init_batch(jcfg, B), init_batch(cfg, B, device="cpu")
    for _ in range(2):
        pts, mask, R, t, z = make_batch_inputs(rng, B, CFG.max_points, moving=True)
        js = jpar.batched_update(js, *(jnp.asarray(a) for a in (pts, mask, R, t, z, z)), jw, jcfg)
        ts = batched_update(ts, *(_t(a) for a in (pts, mask, R, t, z, z)), tw, cfg)
    assert float(ts.layers[:, 2].mean()) > 0.05
    _assert_batches_close(ts, js, 1e-5)


@pytest.mark.parametrize("kw", [CFG_KW, POLAR_KW], ids=["auto-exact", "polar"])
def test_batched_update_matches_per_map_loop(rng, kw):
    """The port's batch against its own per-map updates from the same
    states: the same function, so within 1e-6."""
    B = 3
    cfg = MapConfig(**kw)
    _, tw = _weights_pair()
    states = init_batch(cfg, B, device="cpu")
    singles = [take_map(states, b) for b in range(B)]
    for _ in range(2):
        pts, mask, R, t, z = make_batch_inputs(rng, B, CFG.max_points, moving=True)
        states = batched_update(states, *(_t(a) for a in (pts, mask, R, t, z, z)), tw, cfg)
        singles = [
            core.update_pointcloud(s, _t(pts[b]), _t(mask[b]), _t(R[b]), _t(t[b]), float(z[b]), float(z[b]), tw, cfg)
            for b, s in enumerate(singles)
        ]
    for b in range(B):
        for name, x, y in zip(states._fields, take_map(states, b), singles[b]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, err_msg=f"map {b} {name}")


@pytest.mark.parametrize("B", [1, 4])
def test_batched_polar_step_launches_k1_three_times(monkeypatch, rng, B):
    """K1's wrapper is called three times per batched polar step whatever B
    is (error counting, fusion, the cube), each with the whole batch."""
    calls = []
    real = cuda_scatter.scatter_add_streams

    def counting(idx, mask, values, n_cells):
        calls.append(tuple(values.shape) + (n_cells,))
        return real(idx, mask, values, n_cells)

    monkeypatch.setattr(cuda_scatter, "scatter_add_streams", counting)
    cfg = MapConfig(**POLAR_KW)
    pts, mask, R, t, z = make_batch_inputs(rng, B, cfg.max_points)
    batched_update(init_batch(cfg, B, device="cpu"), *(_t(a) for a in (pts, mask, R, t, z, z)), default_weights(), cfg)
    cells, n = cfg.cell_n**2, cfg.max_points
    cube = cfg.azimuth_bins * (cfg.n_ray_steps + 2) * cfg.raycast_elevation_bins
    assert calls == [(B, 2, n, cells), (B, 4, n, cells), (B, 2, n, cube)]


def test_polar_evaluation_in_chunks_equals_one_pass(monkeypatch, rng):
    """A batch whose per-cell evaluation is cut into chunks of maps (one map
    each here) gives the one-pass result, and still one cube launch."""
    from elevation_mapping_cupy_torch.ops import raycast

    cfg = MapConfig(**POLAR_KW)
    B = 3
    pts, mask, R, t, z = make_batch_inputs(rng, B, cfg.max_points, moving=True)
    args = [_t(a) for a in (pts, mask, R, t, z, z)]
    _, tw = _weights_pair()
    whole = batched_update(init_batch(cfg, B, device="cpu"), *args, tw, cfg)
    monkeypatch.setattr(raycast, "POLAR_EVAL_BYTES", 1)
    calls = []
    real = cuda_scatter.scatter_add_streams
    monkeypatch.setattr(cuda_scatter, "scatter_add_streams", lambda *a: calls.append(a[2].shape) or real(*a))
    chunked = batched_update(init_batch(cfg, B, device="cpu"), *args, tw, cfg)
    assert len(calls) == 3
    for name, a, b in zip(whole._fields, whole, chunked):
        assert torch.equal(a, b), name


def test_exact_batch_matches_jax(rng):
    """raycast_mode="exact" under a batch (one K2 launch for every map):
    every field within 1e-5 of JAX's batched_update."""
    jnp, JaxConfig, jpar, jtrav = _jax()
    kw = dict(CFG_KW, raycast_mode="exact")
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    B = 3
    js, ts = jpar.init_batch(jcfg, B), init_batch(cfg, B, device="cpu")
    for step in range(3):
        pts, mask, R, t, z = make_batch_inputs(rng, B, cfg.max_points, moving=True)
        if step == 2:
            pts[..., 2] = -0.45  # a low sweep whose rays cross the mapped cells
        js = jpar.batched_update(js, *(jnp.asarray(a) for a in (pts, mask, R, t, z, z)), jtrav.default_weights(), jcfg)
        ts = batched_update(ts, *(_t(a) for a in (pts, mask, R, t, z, z)), default_weights(), cfg)
        if step == 1:
            from elevation_mapping_cupy_tpu import core as jcore
            import jax

            js = jax.vmap(lambda s: jcore.update_time(s, jcfg))(js)
            ts = core.update_time(ts, cfg)
    _assert_batches_close(ts, js, 1e-5)


def _roll_reference(x, s0, s1, value):
    """The per-map shift as ``torch.roll`` and slice fills do it."""
    out = torch.roll(x, shifts=(s0, s1), dims=(-2, -1))
    if s0 > 0:
        out[..., :s0, :] = value
    elif s0 < 0:
        out[..., s0:, :] = value
    if s1 > 0:
        out[..., :, :s1] = value
    elif s1 < 0:
        out[..., :, s1:] = value
    return out


@pytest.mark.parametrize("shift", [(0, 0), (3, -2), (-5, 7), (1, 0), (0, -1), (25, -3), (-30, -30)])
def test_shift_map_xy_is_a_roll(rng, shift):
    """The device-side shift equals torch.roll with the revealed rows and
    columns reset, bit for bit, including shifts past the map's side."""
    cfg = MapConfig(**dict(CFG_KW, semantic_layers=("rgb", "grass")))
    n = cfg.cell_n
    arrays = {k: v.copy() for k, v in state_to_numpy(init_state(cfg, "cpu")).items()}
    for k in ("layers", "semantic", "sem_new"):
        arrays[k] = rng.normal(size=arrays[k].shape).astype(np.float32)
    arrays["id_max"] = rng.integers(0, 2**32, arrays["id_max"].shape, dtype=np.uint64).astype(np.uint32)
    state = state_from_numpy(arrays, "cpu")
    got = core.shift_map_xy(state, shift[0], shift[1], cfg)
    layers = _roll_reference(state.layers, *shift, 0.0)
    layers[1] = _roll_reference(state.layers[1], *shift, cfg.initial_variance)
    want = state._replace(
        layers=layers,
        semantic=_roll_reference(state.semantic, *shift, 0.0),
        sem_new=_roll_reference(state.sem_new, *shift, 0.0),
        id_max=_roll_reference(state.id_max, *shift, 0),
    )
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and torch.equal(a, b), f"{name} at shift {shift}"
    assert got.layers.shape[-1] == n


def test_batched_move_to_matches_jax(rng):
    """Batched recentering with per-map positions: bit for bit JAX's
    batched_move_to, and bit for bit the port's per-map move_to."""
    jnp, JaxConfig, jpar, jtrav = _jax()
    jcfg = JaxConfig(**CFG_KW)
    B = 3
    pts, mask, R, t, z = make_batch_inputs(rng, B, CFG.max_points)
    js = jpar.batched_update(jpar.init_batch(jcfg, B), *(jnp.asarray(a) for a in (pts, mask, R, t, z, z)),
                             jtrav.default_weights(), jcfg)
    ts = state_from_numpy(js, "cpu")
    positions = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    singles = [core.move_to(take_map(ts, b), _t(positions[b]), _t(Rs[b]), CFG) for b in range(B)]
    js = jpar.batched_move_to(js, jnp.asarray(positions), jnp.asarray(Rs), jcfg)
    ts = batched_move_to(ts, _t(positions), _t(Rs), CFG)
    got = state_to_numpy(ts)
    for name in got:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)
    for b in range(B):
        for name, x, y in zip(ts._fields, take_map(ts, b), singles[b]):
            assert torch.equal(x, y), f"map {b} {name}"


def _image_case(rng, B, mode):
    """test_parallel.py's batched-image scene: per-map height fields, one
    4-plane image each, cameras 5 cm apart."""
    channels = ("rgb", "mask")
    kw = dict(resolution=0.1, map_length=2.0, max_points=64, image_occlusion_mode=mode, semantic_layers=channels,
              image_channel_fusions=(("rgb", "color"), ("mask", "exponential"), ("default", "exponential")))
    n = MapConfig(**kw).cell_n
    K = np.array([[50, 0, 32], [0, 50, 24], [0, 0, 1]], np.float32)
    Rm = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    heights = rng.uniform(-0.02, 0.02, (B, n, n)).astype(np.float32)
    heights[:, 8:11, 4:9] = 0.4  # a wall that hides cells from the camera
    imgs = rng.uniform(0, 1, (B, 4, 48, 64)).astype(np.float32)
    imgs[:, :3] = np.floor(imgs[:, :3] * 256)  # rgb planes hold 0-255
    ts = np.stack([np.array([0.0, 0.05 * b, 1.0], np.float32) for b in range(B)])
    return kw, channels, heights, imgs, ts, K, Rm


@pytest.mark.parametrize("mode", ["bresenham", "shadow"])
def test_batched_input_image_matches_jax(rng, mode):
    """One image per map, all maps in one pass: semantic layers within 1e-5
    of JAX's batched_input_image (packed colours bit for bit), and equal to
    the port's per-map input_image."""
    jnp, JaxConfig, jpar, _ = _jax()
    B = 3
    kw, channels, heights, imgs, ts, K, Rm = _image_case(rng, B, mode)
    jcfg, cfg = JaxConfig(**kw), MapConfig(**kw)
    jstates = jpar.init_batch(jcfg, B)
    jstates = jstates._replace(layers=jstates.layers.at[:, 0].set(jnp.asarray(heights)).at[:, 2].set(1.0))
    tstates = state_from_numpy(jstates, "cpu")
    args = (np.broadcast_to(Rm, (B, 3, 3)), ts, np.broadcast_to(K, (B, 3, 3)), np.zeros((B, 5), np.float32))
    singles = [
        core.input_image(take_map(tstates, b), _t(imgs[b]), _t(Rm), _t(ts[b]), _t(K), torch.zeros(5), cfg, channels)
        for b in range(B)
    ]
    jout = jpar.batched_input_image(jstates, jnp.asarray(imgs), *(jnp.asarray(a) for a in args), jcfg, channels)
    tout = batched_input_image(tstates, _t(imgs), *(_t(a) for a in args), cfg, channels)
    got, want = tout.semantic.numpy(), np.asarray(jout.semantic)
    rgb = cfg.semantic_layers.index("rgb")
    np.testing.assert_array_equal(got[:, rgb].view(np.uint32), want[:, rgb].view(np.uint32))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[:, rgb] != 0).mean() > 0.2 and (got[:, cfg.semantic_layers.index("mask")] != 0).mean() > 0.2
    for b in range(B):
        assert torch.equal(tout.semantic[b], singles[b].semantic), f"map {b}"


def test_batch_stats_matches_jax(rng):
    jnp, JaxConfig, jpar, jtrav = _jax()
    jcfg = JaxConfig(**CFG_KW)
    B = 4
    pts, mask, R, t, z = make_batch_inputs(rng, B, CFG.max_points, moving=True)
    js = jpar.batched_update(jpar.init_batch(jcfg, B), *(jnp.asarray(a) for a in (pts, mask, R, t, z, z)),
                             jtrav.default_weights(), jcfg)
    js = js._replace(additive_mean_error=jnp.asarray(rng.normal(0, 0.01, B).astype(np.float32)))
    want = jpar.batch_stats(js)
    got = batch_stats(state_from_numpy(js, "cpu"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert 0.0 < float(got["frac_valid_mean"]) < 1.0


@pytest.mark.parametrize("semantic", [(), ("rgb", "grass")])
def test_checkpoint_round_trip(tmp_path, rng, semantic):
    """save/restore is bit for bit, with a template or without; the zero-size
    semantic leaves of a map without channels come back from the record."""
    import json

    cfg = MapConfig(**dict(CFG_KW, semantic_layers=semantic))
    B = 3
    pts, mask, R, t, z = make_batch_inputs(rng, B, cfg.max_points)
    states = batched_update(init_batch(cfg, B, device="cpu"), *(_t(a) for a in (pts, mask, R, t, z, z)),
                            default_weights(), cfg)
    if semantic:
        states = states._replace(id_max=torch.full_like(states.id_max, 2**32 - 7))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, states)
    meta = json.load(open(os.path.join(path, checkpoint.META)))
    assert meta["global_batch"] == B and meta["slices"] == [[0, B]]
    assert sorted(meta["empty_leaves"]) == ([] if semantic else ["id_max", "sem_new", "semantic"])
    template = init_batch(cfg, B, device="cpu")
    for back in (checkpoint.restore(path, template=template), checkpoint.restore(path, device="cpu")):
        for name, a, b in zip(states._fields, states, back):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    with pytest.raises(FileExistsError):
        checkpoint.save(path, states, force=False)
    with pytest.raises(ValueError, match="checkpoint holds"):
        checkpoint.restore(path, template=init_batch(cfg, B + 1, device="cpu"))


def test_distributed_helpers_single_process(rng, monkeypatch):
    """Without a coordinator everything is one process: initialize is
    False, the pod mesh is (1, 1) on this process's device, this process
    owns every env, and HostFeed puts its data on that device."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    mesh = distributed.pod_mesh(("host", "chip"), device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("host", "chip")
    assert distributed.process_local_slice(32) == (0, 32)
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    feed = distributed.HostFeed(16, make_mesh((1,), ("host",), devices="cpu"))
    local = rng.standard_normal((16, 5, 3)).astype(np.float32)
    arr = feed.globalize(local)
    assert arr.device.type == "cpu"
    np.testing.assert_array_equal(arr.numpy(), local)
    with pytest.raises(ValueError, match="feeds envs"):
        feed.globalize(local[:8])
    states = init_batch(CFG, 4, device="cpu")
    sharded = shard_states(states, make_mesh(devices="cpu"), "env")
    assert all(torch.equal(a, b) for a, b in zip(states, sharded))
    with pytest.raises(ValueError, match="process group"):
        make_mesh((8,), ("env",), devices="cpu")
    with pytest.raises(ValueError, match="no axis"):
        shard_states(states, make_mesh(devices="cpu"), "x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


def _worker_inputs(pid: int, n_local: int):
    rng = np.random.default_rng(pid)
    pts = rng.uniform(-0.9, 0.9, (n_local, 256, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-0.1, 0.3, (n_local, 256))
    return pts


WORKER_CFG = MapConfig(resolution=0.1, map_length=2.0, max_ray_length=0.5, max_points=256)


def _worker(port: int, pid: int, world: int, ckpt: str) -> None:
    """One process of the two-process run: a gloo group, a (2, 1) pod mesh,
    its own two envs fed through HostFeed, the env-sharded batched update,
    the all-reduced stats, and a checkpoint written by both processes and
    read back by each."""
    torch.set_num_threads(1)
    ok = distributed.initialize(f"localhost:{port}", world, pid, device="cpu")
    assert ok and distributed.process_count() == world
    mesh = distributed.pod_mesh(("host", "chip"))
    assert tuple(mesh.mesh.shape) == (world, 1)
    B = 4
    lo, hi = distributed.process_local_slice(B)
    assert hi - lo == B // world
    states = shard_states(init_batch(WORKER_CFG, B, device="cpu"), mesh, "host")
    assert states.layers.shape[0] == hi - lo
    feed = distributed.HostFeed(B, mesh, axis="host")
    n = hi - lo
    pts = feed.globalize(_worker_inputs(pid, n))
    mask = feed.globalize(np.ones((n, WORKER_CFG.max_points), bool))
    R = feed.globalize(np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy())
    t = feed.globalize(np.tile(np.array([0, 0, 0.5], np.float32), (n, 1)))
    z = feed.globalize(np.zeros((n,), np.float32))
    out = batched_update(states, pts, mask, R, t, z, z, default_weights(), WORKER_CFG)
    fv = float(batch_stats(out)["frac_valid_mean"])
    assert np.isfinite(fv) and fv > 0.0
    checkpoint.save(ckpt, out)
    back = checkpoint.restore(ckpt, template=shard_states(init_batch(WORKER_CFG, B, device="cpu"), mesh, "host"))
    assert all(torch.equal(a, b) for a, b in zip(out, back))
    distributed.shutdown()
    print(f"proc{pid} ok frac_valid={fv!r}", flush=True)


def test_two_process_distributed_update(tmp_path):
    """Two OS processes form a gloo group and a (2 processes x 1 device)
    pod mesh; each feeds and updates its own envs, and the all-reduced
    frac_valid agrees across processes and with the whole batch updated in
    one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["OMP_NUM_THREADS"] = "1"
    ckpt = str(tmp_path / "ckpt")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(i), "2", ckpt],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        )
        for i in range(2)
    ]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out}"
        assert f"proc{i} ok frac_valid=" in out
    vals = [float(out.split("frac_valid=")[1].split()[0]) for out in outs]
    assert vals[0] == vals[1]
    # the same four envs in one process, no group
    pts = np.concatenate([_worker_inputs(i, 2) for i in range(2)])
    B = 4
    out = batched_update(
        init_batch(WORKER_CFG, B, device="cpu"), _t(pts), torch.ones((B, WORKER_CFG.max_points), dtype=torch.bool),
        torch.eye(3).expand(B, 3, 3), torch.tensor([0, 0, 0.5]).expand(B, 3), torch.zeros(B), torch.zeros(B),
        default_weights(), WORKER_CFG,
    )
    np.testing.assert_allclose(vals[0], float(batch_stats(out)["frac_valid_mean"]), rtol=1e-6)


def test_import_scan_reaches_the_batched_modules():
    """tests/test_torch_core.py's import scan covers the new modules, and
    none of them imports JAX, the JAX package or orbax."""
    import ast

    from tests.test_torch_core import PKG, _forbidden_imports, _imported_modules, _port_files

    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for sub in ("parallel/__init__.py", "parallel/batch.py", "parallel/mesh.py", "parallel/distributed.py",
                "parallel/checkpoint.py", "runtime/datagen.py"):
        path = os.path.join(PKG, sub)
        assert sub.replace("/", os.sep) in rel, f"the scan does not reach {sub}"
        assert not _forbidden_imports(path)
        assert not [m for m in _imported_modules(path) if m.split(".")[0] == "orbax"]
        ast.parse(open(path).read())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
