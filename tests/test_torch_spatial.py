"""Spatial sharding of one map in the PyTorch port, held to the JAX package.

Every spatial test of ``tests/test_parallel.py`` has a mirror here, with
its config, seed and tolerances (1e-5 on layers and normals, 1e-4 on
semantic layers). The JAX package runs them on an 8-device CPU mesh; the
port runs one process per block, so each mirror runs in a gloo world of 2
or 4 processes on the CPU: (8,) meshes become (4,) (and (2,) where a world
of two suffices), (4, 2) becomes (2, 2), (2, 4) becomes (2, 2) and
(2, 2, 2) becomes (1, 2, 2). Two worlds are spawned for the whole file, one
of each size, and each runs every case of its size (``_CASES``); the test
process makes the inputs, computes the JAX references while the worlds
run, and compares. Every sharded map is also held to the port's own
unsharded update, bit for bit.

The worlds are this file run as a script
(``python tests/test_torch_spatial.py PORT RANK SIZE DIR``): plain torch
processes, one thread each, that import no JAX.

Every JAX config here resolves to the exact cleanup, so cases with
``raycast_mode="polar"`` (and one with the gated march) hold the polar
evaluation of a block and K2's block gate to JAX too.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from elevation_mapping_cupy_torch import MapConfig, core  # noqa: E402
from elevation_mapping_cupy_torch.nn.traversability import (  # noqa: E402
    DEFAULT_WEIGHT_FILE, default_weights, load_weights_npz,
)
from elevation_mapping_cupy_torch.ops.geometry import Block  # noqa: E402
from elevation_mapping_cupy_torch.state import init_state  # noqa: E402

WORKER_TIMEOUT_S = 240
LAYER_TOL = 1e-5
SEMANTIC_TOL = 1e-4
EYE = np.eye(3, dtype=np.float32)
SENSOR = np.array([0, 0, 0.5], np.float32)

# ---------------------------------------------------------------------------
# the cases: name -> (world size, kind, arguments)
# ---------------------------------------------------------------------------

ROW_CFG = dict(resolution=0.1, map_length=6.2, max_ray_length=0.5, max_points=2048)       # cell_n 64
BIG_CFG = dict(resolution=0.1, map_length=102.2, max_ray_length=0.5, max_points=8192)     # cell_n 1024
SEM_CFG = dict(resolution=0.1, map_length=2.2, max_ray_length=0.5, max_points=512)        # cell_n 24
TILE_CFG = dict(resolution=0.1, map_length=3.0, max_ray_length=0.5, max_points=2048)      # cell_n 32
SHORT_CFG = dict(resolution=0.1, map_length=1.4, max_ray_length=0.5, max_points=512)      # cell_n 16
MOVE = np.array([0.5, -0.3, 0.1], np.float32)
FLEET_MOVE = np.array([0.35, -0.15, 0], np.float32)

# every point-cloud fusion, class_max over two channels of 20 ids by
# position, then 26: 41 distinct ids with the map's, past class_max's 32, so
# the ids a block holds would decide the buckets if they were not joined
FUSIONS = ("rgb", "f_avg", "f_bayes", "f_dir", "max_a", "max_b")
FUSION_TABLE = (("rgb", "color"), ("f_avg", "average"), ("f_bayes", "bayesian_inference"),
                ("f_dir", "class_bayesian"), ("max_.*", "class_max"))
ROWS4 = ((4,), ("x",), "x", None)
ROWS2 = ((2,), ("x",), "x", None)
TILES = ((2, 2), ("x", "y"), "x", "y")

_CASES = {
    # test_halo_smooth_matches_unsharded (an (8,) "env" mesh)
    "smooth": (4, "smooth", {}),
    # the other halo stencils: max-dilation and the zero-edge halo, with a
    # reach of 3 and of 5 (wider than the blocks' 4 rows)
    "halo": (4, "halo", {}),
    # test_sharded_scatter_matches_local, with its 1026 pad path
    "scatter_rows": (4, "scatter", {"mesh": ROWS4, "shapes": ((1024, 1024), (1026, 1026))}),
    # test_sharded_scatter_2d_mesh_matches_local ((4, 2) -> (2, 2))
    "scatter_tiles": (4, "scatter", {"mesh": TILES, "shapes": ((128, 256), (130, 258))}),
    # test_spatial_sharding_matches_unsharded and its move_to, on 4 and 2
    # processes, the exact march (the config's) and the polar cleanup
    "rows4_exact": (4, "step", {"cfg": ROW_CFG, "mesh": ROWS4, "span": 2.9, "move": MOVE}),
    "rows2_exact": (2, "step", {"cfg": ROW_CFG, "mesh": ROWS2, "span": 2.9, "move": MOVE}),
    "rows4_polar": (4, "step", {"cfg": dict(ROW_CFG, raycast_mode="polar"), "mesh": ROWS4, "span": 2.9,
                                "move": MOVE}),
    # the gated march (K2's gate table on a block), held to the port's
    # unsharded gated march, which tests/test_torch_raycast_exact.py holds
    # to JAX's
    "rows2_gated": (2, "step", {"cfg": dict(ROW_CFG, raycast_exact_impl="gated"), "mesh": ROWS2, "span": 2.9,
                                "jax": False}),
    # blocks of 4 rows, shorter than the ghost zone of 6: the ghost rows
    # come from the processes beyond the neighbour
    "short4": (4, "step", {"cfg": SHORT_CFG, "mesh": ROWS4, "span": 0.6, "move": MOVE}),
    # drift compensation on: its error sums cross the processes (three
    # updates of the same ground, 0.5 of position noise, 5 mm lower each time)
    "drift4": (4, "step", {"cfg": ROW_CFG, "mesh": ROWS4, "span": 2.9, "steps": 3, "noise": 0.5}),
    # the shipped CNN weights: traversability across the block borders
    "rows4_weights": (4, "step", {"cfg": ROW_CFG, "mesh": ROWS4, "span": 2.9, "weights": True}),
    # test_spatial_sharding_matches_unsharded_1024 (8192 points)
    "big2": (2, "step", {"cfg": BIG_CFG, "mesh": ROWS2, "span": 50.0}),
    # test_spatial_semantic_matches_unsharded
    "semantic4": (4, "step", {"cfg": dict(SEM_CFG, semantic_layers=("rgb", "grass")), "mesh": ROWS4,
                              "span": 0.9, "channels": ("rgb", "grass")}),
    # the six fusions (class_max's ids joined over the tiles), two updates
    "fusions4": (4, "step", {"cfg": dict(SEM_CFG, semantic_layers=FUSIONS, pointcloud_channel_fusions=FUSION_TABLE),
                             "mesh": TILES, "span": 0.9, "channels": FUSIONS, "steps": 2}),
    # test_spatial_2d_tiling_matches_unsharded ((4, 2) -> (2, 2)), both
    # cleanups
    "tiles_exact": (4, "step", {"cfg": TILE_CFG, "mesh": TILES, "span": 1.4, "move": MOVE}),
    "tiles_polar": (4, "step", {"cfg": dict(TILE_CFG, raycast_mode="polar"), "mesh": TILES, "span": 1.4}),
    "tiles_weights": (4, "step", {"cfg": TILE_CFG, "mesh": TILES, "span": 1.4, "weights": True}),
    # test_batched_spatial_matches_sequential, both mesh specs
    "fleet_rows": (4, "batched", {"cfg": SEM_CFG, "mesh": ((2, 2), ("env", "x"), "x", None), "B": 4}),
    "fleet_tiles": (4, "batched", {"cfg": SEM_CFG, "mesh": ((1, 2, 2), ("env", "x", "y"), "x", "y"), "B": 4}),
    "fleet_polar": (4, "batched", {"cfg": dict(SEM_CFG, raycast_mode="polar"),
                                   "mesh": ((1, 2, 2), ("env", "x", "y"), "x", "y"), "B": 4}),
    # test_batched_spatial_semantic_and_move
    "fleet_semantic_move": (4, "batched", {"cfg": dict(SEM_CFG, semantic_layers=("grass",)),
                                           "mesh": ((2, 2), ("env", "x"), "x", None), "B": 2,
                                           "channels": ("grass",), "move": FLEET_MOVE}),
    # test_spatial_sharding_rejects_indivisible_rows (cell_n 22 over 4)
    "indivisible": (4, "indivisible", {"cfg": dict(resolution=0.1, map_length=2.0, max_points=64), "mesh": ROWS4}),
}


def _case_inputs(name: str) -> dict:
    """The inputs of a case, drawn as its JAX test draws them (a fresh
    ``default_rng(1234)``, the conftest's ``rng``)."""
    size, kind, a = _CASES[name]
    rng = np.random.default_rng(1234)
    if kind == "smooth":
        return {"x": rng.normal(0, 1, (64, 128)).astype(np.float32)}
    if kind == "halo":
        return {"x": rng.normal(0, 1, (16, 24)).astype(np.float32)}
    if kind == "scatter":
        out = {}
        for h, w in a["shapes"]:
            n = 4096
            out[f"idx{h}"] = rng.integers(0, h * w, n).astype(np.int32)
            out[f"mask{h}"] = rng.random(n) < 0.9
            out[f"v0_{h}"] = rng.normal(0, 1, n).astype(np.float32)
            out[f"v1_{h}"] = rng.integers(0, 2, n).astype(np.float32)
        return out
    if kind == "step":
        cfg = MapConfig(**a["cfg"])
        n = cfg.max_points
        ch = a.get("channels", ())
        if ch == FUSIONS:
            pts = rng.uniform(-0.9, 0.9, (2, n, 3 + len(FUSIONS))).astype(np.float32)
            pts[..., 2] = rng.uniform(-0.1, 0.3, (2, n)).astype(np.float32)
            rgbs = rng.integers(0, 255, (2, n, 3)).astype(np.uint32)
            pts[..., 3] = ((rgbs[..., 0] << 16) | (rgbs[..., 1] << 8) | rgbs[..., 2]).view(np.float32)
            # the first update's ids follow x (the map's rows), so each
            # block holds its own; the second's are drawn from 15-40
            ids = [np.repeat((1 + (pts[0, :, :1] + 0.9) / 1.8 * 20).astype(np.uint32), 2, axis=1),
                   rng.integers(15, 41, (n, 2)).astype(np.uint32)]
            for k in range(2):
                half = rng.uniform(0.2, 1.0, (n, 2)).astype(np.float16).view(np.uint16)
                pts[k, :, 7:9] = ((ids[k] << 16) | half).view(np.float32)
            return {"pts": pts, "mask": np.ones(n, bool)}
        if "rgb" in ch:  # test_spatial_semantic_matches_unsharded's draws
            pts = rng.uniform(-0.9, 0.9, (n, 3 + 2)).astype(np.float32)
            pts[:, 2] = rng.uniform(-0.1, 0.3, n).astype(np.float32)
            rgbs = rng.integers(0, 255, (n, 3)).astype(np.uint32)
            pts[:, 3] = ((rgbs[:, 0] << 16) | (rgbs[:, 1] << 8) | rgbs[:, 2]).view(np.float32)
            pts[:, 4] = rng.uniform(0, 1, n).astype(np.float32)
        elif a.get("steps"):
            pts = rng.uniform(-a["span"], a["span"], (n, 3)).astype(np.float32)
            pts[:, 2] = rng.uniform(-0.1, 0.3, n).astype(np.float32)
            pts = np.stack([pts - np.array([0, 0, 0.005 * k], np.float32) for k in range(a["steps"])])
        else:
            pts = rng.uniform(-a["span"], a["span"], (n, 3)).astype(np.float32)
            pts[:, 2] = rng.uniform(-0.1, 0.3, n).astype(np.float32)
        return {"pts": pts, "mask": np.ones(n, bool)}
    if kind == "batched":
        cfg = MapConfig(**a["cfg"])
        B, n = a["B"], cfg.max_points
        if a.get("channels"):  # test_batched_spatial_semantic_and_move's draws
            pts = rng.uniform(-0.9, 0.9, (B, n, 4)).astype(np.float32)
            pts[..., 2] = rng.uniform(-0.1, 0.3, (B, n)).astype(np.float32)
            pts[..., 3] = rng.uniform(0, 1, (B, n)).astype(np.float32)
        else:  # test_parallel.make_batch_inputs
            pts = rng.uniform(-0.9, 0.9, (B, n, 3)).astype(np.float32)
            pts[..., 2] = rng.uniform(-0.1, 0.3, (B, n)).astype(np.float32)
        return {"pts": pts, "mask": np.ones((B, n), bool)}
    return {}


def _cfg(a) -> MapConfig:
    return MapConfig(**a["cfg"])


def _weights(a):
    return load_weights_npz(DEFAULT_WEIGHT_FILE) if a.get("weights") else default_weights()


# ---------------------------------------------------------------------------
# the worlds (run as a script: no JAX)
# ---------------------------------------------------------------------------

def _run_case(name: str, inp: dict, rank: int) -> dict:
    from elevation_mapping_cupy_torch.ops import scatter as sc
    from elevation_mapping_cupy_torch.parallel import make_mesh
    from elevation_mapping_cupy_torch.parallel import spatial
    from elevation_mapping_cupy_torch.parallel.halo import (
        halo_exchange_rows, sharded_dilation, sharded_uniform_smooth,
    )
    from elevation_mapping_cupy_torch.parallel.sharded_scatter import (
        sharded_scatter_add_streams_2d, sharded_scatter_ctx,
    )
    from elevation_mapping_cupy_torch.state import init_batch

    size, kind, a = _CASES[name]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    out = {}
    if kind == "smooth":
        mesh = make_mesh((size,), ("env",))
        h = 64 // size
        idx = mesh.get_local_rank(0)
        smooth = sharded_uniform_smooth(mesh, passes=2, size=3, axis_name="env")
        out["block"] = smooth(t(inp["x"][idx * h : (idx + 1) * h])).numpy()
        return out
    if kind == "halo":
        mesh = make_mesh((size,), ("x",))
        h = 16 // size
        idx = mesh.get_local_rank(0)
        block = t(inp["x"][idx * h : (idx + 1) * h])
        for reach in (3, 5):
            out[f"dilation{reach}"] = sharded_dilation(mesh, reach)(block).numpy()
            for edge in ("zero", "neg_inf", "symmetric"):
                out[f"halo{reach}_{edge}"] = halo_exchange_rows(block, reach, mesh, "x", edge).numpy()
        return out
    shape, names, axis, col_axis = a["mesh"]
    mesh = make_mesh(shape, names)
    if kind == "scatter":
        for h, w in a["shapes"]:
            args = (t(inp[f"idx{h}"]), [t(inp[f"v0_{h}"]), t(inp[f"v1_{h}"])], t(inp[f"mask{h}"]))
            got = sharded_scatter_add_streams_2d(h, w, *args, mesh, axis, col_axis)
            with sharded_scatter_ctx(mesh, axis, col_axis):
                routed = sc.scatter_add_streams_2d(h, w, *args)
            assert torch.equal(got, routed)
            out[f"block{h}"] = got.numpy()
        return out
    cfg = _cfg(a)
    if kind == "indivisible":
        try:
            spatial.shard_state_spatial(init_state(cfg, "cpu"), mesh, axis, col_axis)
        except ValueError as e:
            out["error"] = np.array(str(e))
        return out
    channels = a.get("channels", ())
    w = _weights(a)
    if kind == "step":
        state = spatial.shard_state_spatial(init_state(cfg, "cpu"), mesh, axis, col_axis)
        step = spatial.spatial_update_pointcloud(mesh, cfg, axis, channels, col_axis)
        z = torch.tensor(float(a.get("noise", 0.0)))
        res = state
        for pts in _updates(inp["pts"]):
            res = step(res, t(pts), t(inp["mask"]), t(EYE), t(SENSOR), z, z, w)
        whole = spatial.gather_spatial(res, mesh, axis, col_axis)
        if "move" in a:
            moved = spatial.spatial_move_to(res, t(a["move"]), t(EYE), cfg, mesh, axis, col_axis)
            out["moved_layers"] = spatial.gather_spatial(moved, mesh, axis, col_axis).layers.numpy()
    else:  # batched
        B = a["B"]
        states = spatial.shard_states_spatial_batched(init_batch(cfg, B, "cpu"), mesh, "env", axis, col_axis)
        parts, part = mesh.size(0), mesh.get_local_rank(0)
        lo, hi = part * B // parts, (part + 1) * B // parts
        b = hi - lo
        step = spatial.batched_spatial_update_pointcloud(mesh, cfg, "env", axis, channels, col_axis)
        R = t(np.broadcast_to(EYE, (b, 3, 3)).copy())
        res = step(states, t(inp["pts"][lo:hi]), t(inp["mask"][lo:hi]), R, t(np.tile(SENSOR, (b, 1))),
                   torch.zeros(b), torch.zeros(b), w)
        if "move" in a:
            res = spatial.spatial_move_to(res, t(np.tile(a["move"], (b, 1))), R, cfg, mesh, axis, col_axis)
        whole = spatial.gather_spatial(res, mesh, axis, col_axis, env_axis="env")
    out.update(layers=whole.layers.numpy(), normal=whole.normal.numpy(), semantic=whole.semantic.numpy(),
               id_max=whole.id_max.numpy(), drift=torch.stack([whole.mean_error, whole.additive_mean_error], -1).numpy(),
               local_rows=np.array(res.layers.shape[-2:]))
    return out


def _world(port: int, rank: int, size: int, folder: str) -> None:
    """One process of a world: every case of its size, results to
    ``folder/out{rank}.npz``."""
    from elevation_mapping_cupy_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", size, rank, device="cpu")
    with np.load(os.path.join(folder, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    results = {}
    for name, (n, _, _) in _CASES.items():
        if n != size:
            continue
        t0 = time.perf_counter()
        inp = {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith(name + "/")}
        for key, val in _run_case(name, inp, rank).items():
            results[f"{name}/{key}"] = val
        results[f"{name}/seconds"] = np.array(time.perf_counter() - t0)
    np.savez(os.path.join(folder, f"out{rank}.npz"), **results)
    distributed.shutdown()
    print(f"rank {rank} of {size} ok", flush=True)


class _Worlds:
    """The two worlds, started together; ``result(size)`` waits for one
    and returns every rank's results."""

    def __init__(self, folder):
        inputs = {f"{name}/{k}": v for name in _CASES for k, v in _case_inputs(name).items()}
        self.dirs, self.procs, self.results = {}, {}, {}
        env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
        env["OMP_NUM_THREADS"] = "1"
        for size in (2, 4):
            d = os.path.join(folder, f"world{size}")
            os.makedirs(d)
            np.savez(os.path.join(d, "inputs.npz"), **inputs)
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            self.dirs[size] = d
            self.procs[size] = [
                subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(r), str(size), d],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
                for r in range(size)
            ]

    def result(self, size: int):
        if size not in self.results:
            procs = self.procs[size]
            try:
                outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode() for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for r, (p, text) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, f"rank {r} of the world of {size} failed:\n{text}"
            ranks = []
            for r in range(size):
                with np.load(os.path.join(self.dirs[size], f"out{r}.npz")) as z:
                    ranks.append({k: z[k] for k in z.files})
            self.results[size] = ranks
        return self.results[size]

    def case(self, name: str):
        return [{k.split("/", 1)[1]: v for k, v in r.items() if k.startswith(name + "/")}
                for r in self.result(_CASES[name][0])]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                p.kill()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(str(tmp_path_factory.mktemp("spatial")))
    yield w
    w.close()


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def _jax():
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu import MapConfig as JCfg
    from elevation_mapping_cupy_tpu import core as jcore
    from elevation_mapping_cupy_tpu import init_state as jinit
    from elevation_mapping_cupy_tpu.nn import traversability as jtrav

    return jnp, JCfg, jcore, jinit, jtrav


def _updates(pts):
    """A case's clouds, one per update: (N, C) is one, (S, N, C) S."""
    return pts if pts.ndim == 3 else pts[None]


def _jax_step(a, pts, mask, move=None):
    """JAX's unsharded update(s) (and move_to) of one map."""
    jnp, JCfg, jcore, jinit, jtrav = _jax()
    cfg = JCfg(**a["cfg"])
    w = jtrav.load_weights_npz(DEFAULT_WEIGHT_FILE) if a.get("weights") else jtrav.default_weights()
    ch = a.get("channels", ())
    out = jinit(cfg)
    noise = jnp.float32(a.get("noise", 0.0))
    for cloud in _updates(pts):
        args = (jnp.asarray(cloud), jnp.asarray(mask), jnp.asarray(EYE), jnp.asarray(SENSOR), noise, noise, w, cfg)
        out = jcore.update_pointcloud_semantic(out, *args, ch) if ch else jcore.update_pointcloud(out, *args)
    if move is not None:
        out = jcore.move_to(out, jnp.asarray(move), jnp.eye(3), cfg)
    return out


def _torch_step(a, pts, mask, move=None):
    """The port's unsharded update(s) (and move_to) of one map."""
    cfg = _cfg(a)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    ch = a.get("channels", ())
    out = init_state(cfg, "cpu")
    noise = float(a.get("noise", 0.0))
    for cloud in _updates(pts):
        args = (t(cloud), t(mask), t(EYE), t(SENSOR), noise, noise, _weights(a), cfg)
        out = core.update_pointcloud_semantic(out, *args, ch) if ch else core.update_pointcloud(out, *args)
    if move is not None:
        out = core.move_to(out, t(move), t(EYE), cfg)
    return out


# ---------------------------------------------------------------------------
# the mirrors
# ---------------------------------------------------------------------------

def test_halo_smooth_matches_unsharded(worlds):
    from elevation_mapping_cupy_tpu.ops import stencil as jstencil

    jnp = _jax()[0]
    x = _case_inputs("smooth")["x"]
    got = np.concatenate([r["block"] for r in worlds.case("smooth")])
    want = np.asarray(jstencil.uniform_smooth(jnp.asarray(x), passes=2, size=3))
    np.testing.assert_allclose(got, want, atol=LAYER_TOL)


@pytest.mark.parametrize("reach", [3, 5])
def test_halo_rows_and_dilation_match_the_whole_map(worlds, reach):
    """``halo_exchange_rows`` in its three edge modes gives each block the
    rows of the padded whole map (numpy's pad), also when the halo is wider
    than a block (4 rows, reach 5); ``sharded_dilation`` equals the
    max-dilation of the whole map."""
    x = _case_inputs("halo")["x"]
    ranks = worlds.case("halo")
    h = x.shape[0] // len(ranks)
    pads = {"zero": np.pad(x, ((reach, reach), (0, 0))),
            "neg_inf": np.pad(x, ((reach, reach), (0, 0)), constant_values=-np.inf),
            "symmetric": np.pad(x, ((reach, reach), (0, 0)), mode="symmetric")}
    for i, r in enumerate(ranks):
        for edge, padded in pads.items():
            np.testing.assert_array_equal(r[f"halo{reach}_{edge}"], padded[i * h : (i + 1) * h + 2 * reach])
    p = np.pad(x, reach, constant_values=-np.inf)
    want = np.max([p[dy : dy + x.shape[0], dx : dx + x.shape[1]] for dy in range(2 * reach + 1)
                   for dx in range(2 * reach + 1)], axis=0)
    np.testing.assert_array_equal(np.concatenate([r[f"dilation{reach}"] for r in ranks]), want)


@pytest.mark.parametrize("name", ["scatter_rows", "scatter_tiles"])
def test_sharded_scatter_matches_local(worlds, name):
    """Shard-local scatter (and the ContextVar route, checked equal in the
    worlds) == JAX's single-device scatter, with the pad path of extents
    that do not divide."""
    from elevation_mapping_cupy_tpu.ops import scatter as jsc

    jnp = _jax()[0]
    _, _, a = _CASES[name]
    shape = a["mesh"][0]
    nc = shape[1] if len(shape) == 2 else 1
    inp = _case_inputs(name)
    ranks = worlds.case(name)
    for h, w in a["shapes"]:
        ref = np.asarray(jsc._scatter_add_streams_2d_local(
            h, w, jnp.asarray(inp[f"idx{h}"]), [jnp.asarray(inp[f"v0_{h}"]), jnp.asarray(inp[f"v1_{h}"])],
            jnp.asarray(inp[f"mask{h}"]), (False, True)))
        rows = [np.concatenate([ranks[i * nc + j][f"block{h}"] for j in range(nc)], axis=-1)
                for i in range(len(ranks) // nc)]
        got = np.concatenate(rows, axis=-2)
        assert got.shape == (2, h, w)
        np.testing.assert_allclose(got, ref, atol=LAYER_TOL)


STEP_CASES = [n for n, (_, k, _) in _CASES.items() if k == "step"]


@pytest.mark.parametrize("name", [n for n in STEP_CASES if _CASES[n][2].get("jax", True)])
def test_spatial_sharding_matches_unsharded(worlds, name):
    """One map sharded over the world == JAX's unsharded update (layers and
    normals 1e-5, semantic 1e-4), and the sharded move_to == JAX's."""
    _, _, a = _CASES[name]
    inp = _case_inputs(name)
    ref = _jax_step(a, inp["pts"], inp["mask"])
    ranks = worlds.case(name)
    got = ranks[0]
    for r in ranks[1:]:  # every process gathers the same map
        np.testing.assert_array_equal(r["layers"], got["layers"])
    np.testing.assert_allclose(got["layers"], np.asarray(ref.layers), atol=LAYER_TOL)
    np.testing.assert_allclose(got["normal"], np.asarray(ref.normal), atol=LAYER_TOL)
    np.testing.assert_allclose(got["drift"], [float(ref.mean_error), float(ref.additive_mean_error)], atol=1e-6)
    if a.get("channels"):
        np.testing.assert_allclose(got["semantic"], np.asarray(ref.semantic), atol=SEMANTIC_TOL)
        np.testing.assert_array_equal(got["id_max"], np.asarray(ref.id_max))
    if "move" in a:
        moved = _jax_step(a, inp["pts"], inp["mask"], a["move"])
        np.testing.assert_allclose(got["moved_layers"], np.asarray(moved.layers), atol=LAYER_TOL)


# the CPU convolution (oneDNN) blocks its work by the input's extent, so
# the CNN on a padded block rounds some cells an ulp off the whole map's:
# with the shipped weights the traversability layer is held within this
TRAV_ULPS_TOL = 1e-6


def _assert_port_bits(got: dict, ref, a, moved=None):
    layers = ref.layers.numpy()
    if a.get("weights"):
        np.testing.assert_allclose(got["layers"][..., 3, :, :], layers[..., 3, :, :], atol=TRAV_ULPS_TOL, rtol=0)
        keep = [i for i in range(layers.shape[-3]) if i != 3]
        np.testing.assert_array_equal(got["layers"][..., keep, :, :], layers[..., keep, :, :])
    else:
        np.testing.assert_array_equal(got["layers"], layers)
    np.testing.assert_array_equal(got["normal"], ref.normal.numpy())
    np.testing.assert_array_equal(got["semantic"].view(np.uint32), ref.semantic.numpy().view(np.uint32))
    np.testing.assert_array_equal(got["id_max"], ref.id_max.numpy())
    np.testing.assert_array_equal(got["drift"], torch.stack([ref.mean_error, ref.additive_mean_error], -1).numpy())
    if moved is not None:
        np.testing.assert_array_equal(got["moved_layers"], moved.layers.numpy())


@pytest.mark.parametrize("name", STEP_CASES)
def test_spatial_sharding_matches_port_unsharded_bits(worlds, name):
    """The sharded map equals the port's unsharded update bit for bit: every
    cell is computed from the same values by the same operations. One float
    sum crosses the processes, the drift compensation's error sum (on only
    in ``drift4``): each process sums its owned points in float32, the
    processes add the partial sums in float64, and for these clouds that
    rounds to the unsharded sum's float32. The one exception is the
    traversability of the shipped CNN weights (``TRAV_ULPS_TOL``)."""
    _, _, a = _CASES[name]
    inp = _case_inputs(name)
    ref = _torch_step(a, inp["pts"], inp["mask"])
    moved = _torch_step(a, inp["pts"], inp["mask"], a["move"]) if "move" in a else None
    _assert_port_bits(worlds.case(name)[0], ref, a, moved)


BATCH_CASES = [n for n, (_, k, _) in _CASES.items() if k == "batched"]


@pytest.mark.parametrize("name", BATCH_CASES)
def test_batched_spatial_matches_sequential(worlds, name):
    """A batch of maps on an (env, rows[, cols]) mesh == each map's own JAX
    update (and move_to, for the semantic fleet), and the port's, in bits."""
    _, _, a = _CASES[name]
    inp = _case_inputs(name)
    got = worlds.case(name)[0]
    for b in range(a["B"]):
        ref = _jax_step(a, inp["pts"][b], inp["mask"][b], a.get("move"))
        np.testing.assert_allclose(got["layers"][b], np.asarray(ref.layers), atol=LAYER_TOL)
        if "move" not in a:
            np.testing.assert_allclose(got["normal"][b], np.asarray(ref.normal), atol=LAYER_TOL)
        if a.get("channels"):
            np.testing.assert_allclose(got["semantic"][b], np.asarray(ref.semantic), atol=SEMANTIC_TOL)
        mine = _torch_step(a, inp["pts"][b], inp["mask"][b], a.get("move"))
        np.testing.assert_array_equal(got["layers"][b], mine.layers.numpy())
        np.testing.assert_array_equal(got["semantic"][b], mine.semantic.numpy())


def test_spatial_sharding_rejects_indivisible_rows(worlds):
    for r in worlds.case("indivisible"):
        assert "divisible" in str(r["error"])


def test_blocks_are_what_the_layout_says(worlds):
    """Each process held only its block: (16, 64) rows of the 64-cell map
    over four, (16, 16) tiles of the 32-cell map over (2, 2)."""
    assert [tuple(r["local_rows"]) for r in worlds.case("rows4_exact")] == [(16, 64)] * 4
    assert [tuple(r["local_rows"]) for r in worlds.case("tiles_exact")] == [(16, 16)] * 4
    assert [tuple(r["local_rows"]) for r in worlds.case("short4")] == [(4, 16)] * 4


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------

def test_local_mesh_step_is_core_update(rng):
    """With no process group the mesh is one process holding the whole map:
    the spatial step is ``core.update_pointcloud``, bit for bit, and the
    sharded move_to is ``core.move_to``."""
    from elevation_mapping_cupy_torch.parallel import make_mesh, spatial

    cfg = MapConfig(**ROW_CFG)
    mesh = make_mesh((1,), ("x",), devices="cpu")
    pts = rng.uniform(-2.9, 2.9, (2048, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.1, 0.3, 2048).astype(np.float32)
    args = (torch.from_numpy(pts), torch.ones(2048, dtype=torch.bool), torch.eye(3), torch.tensor(SENSOR),
            torch.zeros(()), torch.zeros(()), default_weights())
    state = spatial.shard_state_spatial(init_state(cfg, "cpu"), mesh, "x")
    got = spatial.spatial_update_pointcloud(mesh, cfg, "x")(state, *args)
    want = core.update_pointcloud(init_state(cfg, "cpu"), *args, cfg)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    moved = spatial.spatial_move_to(got, torch.tensor(MOVE), torch.eye(3), cfg, mesh, "x")
    assert all(torch.equal(x, y) for x, y in zip(moved, core.move_to(want, torch.tensor(MOVE), torch.eye(3), cfg)))
    assert all(torch.equal(x, y) for x, y in zip(spatial.gather_spatial(got, mesh, "x"), got))


def _march_inputs(rng, cfg, n_rays=3000, aged=True):
    """A mapped state of ROW_CFG's map and the exact march's inputs on it."""
    from elevation_mapping_cupy_torch.ops import geometry, raycast

    pts = rng.uniform(-2.9, 2.9, (n_rays, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.1, 0.3, n_rays).astype(np.float32)
    t = torch.tensor(SENSOR)
    state = core.update_pointcloud(init_state(cfg, "cpu"), torch.from_numpy(pts), torch.ones(n_rays, dtype=torch.bool),
                                   torch.eye(3), t, 0.0, 0.0, default_weights(), cfg)
    if aged:
        for _ in range(7):
            state = core.update_time(state, cfg)
    pts2 = rng.uniform(-2.9, 2.9, (n_rays, 3)).astype(np.float32)
    pts2[:, 2] = rng.uniform(-0.4, 0.1, n_rays).astype(np.float32)
    assoc = geometry.associate_points(torch.from_numpy(pts2), torch.ones(n_rays, dtype=torch.bool), torch.eye(3),
                                      t, cfg)
    inlier = torch.zeros_like(state.layers[0])
    return state, assoc, inlier, t, raycast


BLOCKS = [(0, 0, 64, 64), (0, 0, 21, 64), (21, 0, 43, 64), (8, 13, 30, 17), (40, 33, 24, 31)]


@pytest.mark.parametrize("gated", [False, True])
def test_exact_march_blocks_add_up_to_the_map(rng, gated):
    """K2's plain version on blocks: with the whole map as its block it
    gives the same bits as without one, and blocks that cover the map give
    the whole map's hit counts, upper bounds and decrements, each cell's
    from the same samples in the same order."""
    from elevation_mapping_cupy_torch.ops import cuda_march as cm

    cfg = MapConfig(**ROW_CFG)
    state, assoc, inlier, t, raycast = _march_inputs(rng, cfg)
    n = cfg.cell_n
    pack = raycast.exact_precompute(state.layers, state.normal, inlier, cfg)
    gate = raycast.exact_gate(pack, cfg) if gated else None
    whole = cm.exact_march_reference(pack, assoc.world, assoc.valid, t, cfg, gate)
    assert float(whole.hits.sum()) > 0 and bool(torch.isfinite(whole.ubmin).any())
    same = cm.exact_march_reference(pack, assoc.world, assoc.valid, t, cfg, gate, block=Block.whole(n, n))
    assert all(x is y is None or torch.equal(x, y) for x, y in zip(whole, same))
    for r0, c0, h, w in BLOCKS:
        blk = Block(r0, c0, h, w, n, n)
        sub = state.layers[:, r0 : r0 + h, c0 : c0 + w]
        bpack = raycast.exact_precompute(sub, state.normal[:, r0 : r0 + h, c0 : c0 + w],
                                         inlier[r0 : r0 + h, c0 : c0 + w], cfg)
        bgate = raycast.exact_gate(bpack, cfg, blk) if gated else None
        got = cm.exact_march_reference(bpack, assoc.world, assoc.valid, t, cfg, bgate, block=blk)
        for field in ("dec", "hits", "ubmin"):
            want = getattr(whole, field).reshape(n, n)[r0 : r0 + h, c0 : c0 + w].reshape(-1)
            assert torch.equal(getattr(got, field), want), (blk, field)
        if gated:  # the block's gate passes no more segments than the map's
            assert got.counts[1] == whole.counts[1] and got.counts[0] <= whole.counts[0]


def test_exact_march_rejects_a_block_off_the_map(rng):
    from elevation_mapping_cupy_torch.ops import cuda_march as cm

    cfg = MapConfig(**ROW_CFG)
    state, assoc, inlier, t, raycast = _march_inputs(rng, cfg, 16)
    pack = raycast.exact_precompute(state.layers[:, :8, 60:], state.normal[:, :8, 60:], inlier[:8, 60:], cfg)
    with pytest.raises(ValueError, match="does not lie"):
        cm.exact_march(pack, assoc.world, assoc.valid, t, cfg, block=Block(0, 60, 8, 8, 64, 64))
    with pytest.raises(ValueError, match="pack must be"):
        cm.exact_march(pack, assoc.world, assoc.valid, t, cfg, block=Block(0, 0, 8, 8, 64, 64))


def _border_feature_state(cfg):
    """A map whose one valid cell, (13, 1), is what the dilation reaches
    from (10, 15) through the flat index's row wrap (offset (2, 2) past the
    row's end): the traversability of (7, 12), the last row of the block of
    rows [0, 8), reads that dilated cell."""
    state = init_state(cfg, "cpu")
    layers = state.layers.clone()
    layers[2, 13, 1] = 1.0
    layers[5, 13, 1] = 0.8
    layers[0, 13, 1] = 0.8
    return state._replace(layers=layers)


def _step_on_block(state, cfg, g, weights):
    """The update of the padded block of rows [0, 8) with a ghost zone of
    g rows, without points, through a shard of one process."""
    from elevation_mapping_cupy_torch.parallel.halo import Axis
    from elevation_mapping_cupy_torch.parallel.spatial import SpatialShard

    n = cfg.cell_n
    one = Axis((0,), 0, None)
    shard = SpatialShard(one, one, Block(0, 0, 8, n, n, n), Block(0, 0, 8 + g, n, n, n))
    padded = state._replace(**{f: getattr(state, f)[..., : 8 + g, :][None] for f in ("layers", "normal")},
                            **{f: getattr(state, f)[None] for f in ("semantic", "sem_new", "id_max", "center",
                                                                      "rotation", "mean_error",
                                                                      "additive_mean_error")})
    none = torch.zeros((1, 1, 3))
    out, _ = core.update_batch_aux(padded, none, torch.zeros((1, 1), dtype=torch.bool), torch.eye(3)[None],
                                   torch.tensor(SENSOR)[None], 0.0, 0.0, weights, cfg, shard=shard)
    return out.layers[0, :, :8], out.normal[0, :, :8]


def test_ghost_width_is_the_stencil_reach():
    """A feature placed where the stencils reach farthest across a block's
    border: with ``ghost_width`` rows of ghost zone the block's update equals
    the whole map's; with one row less the border row's traversability
    differs. The reach is the dilation's size plus one (its flat row wrap)
    plus the CNN's 3."""
    from elevation_mapping_cupy_torch.parallel.spatial import ghost_width

    cfg = MapConfig(resolution=0.1, map_length=1.4, max_ray_length=0.5, max_points=64,
                    enable_overlap_clearance=False)
    assert cfg.cell_n == 16 and cfg.dilation_size == 2
    g = ghost_width(cfg)
    assert g == 6 and ghost_width(cfg.replace(dilation_size=3)) == 7
    weights = load_weights_npz(DEFAULT_WEIGHT_FILE)
    state = _border_feature_state(cfg)
    whole = core.update_pointcloud(state, torch.zeros((1, 3)), torch.zeros(1, dtype=torch.bool), torch.eye(3),
                                   torch.tensor(SENSOR), 0.0, 0.0, weights, cfg)
    layers, normal = _step_on_block(state, cfg, g, weights)
    assert torch.equal(layers, whole.layers[:, :8]) and torch.equal(normal, whole.normal[:, :8])
    short, _ = _step_on_block(state, cfg, g - 1, weights)
    assert not torch.equal(short[3, 7], whole.layers[3, 7])


def test_import_scan_reaches_the_spatial_modules():
    """tests/test_torch_core.py's import scan covers the three new modules,
    and none of them imports JAX or the JAX package."""
    import ast

    from tests.test_torch_core import PKG, _forbidden_imports, _port_files

    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for sub in ("parallel/halo.py", "parallel/sharded_scatter.py", "parallel/spatial.py"):
        path = os.path.join(PKG, sub)
        assert sub.replace("/", os.sep) in rel, f"the scan does not reach {sub}"
        assert not _forbidden_imports(path)
        ast.parse(open(path).read())


if __name__ == "__main__":
    _world(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
