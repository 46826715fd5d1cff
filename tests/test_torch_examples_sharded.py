"""The port's sharded-world example
(``elevation_mapping_cupy_torch/examples/large_world_sharded.py``) against
the JAX package on the CPU.

The example starts its own ``torch.distributed`` world. Here it runs at
the full 512 x 512 cells but in a gloo world of 2 processes (the example
ships 8) and through 4 of its 12 frames, to keep the file well inside the
suite's time. Its gathered map is held to JAX's unsharded
``core.update_pointcloud`` on the same NumPy-seeded clouds: every layer and
the normals within 1e-4 on >= 99.9 % of cells, NaN where JAX has NaN. Then
the example's ``main`` prints from that run, and the invariants
``tests/test_examples.py`` asserts of the JAX example's output hold of the
port's (for a world of 2).
"""

import sys

import numpy as np
import pytest
import torch

from elevation_mapping_cupy_torch.examples import large_world_sharded as lw

WORLD = 2
FRAMES = 4
ATOL = 1e-4
MIN_SHARE = 0.999


def _jax_world(frames):
    """JAX's unsharded update of the example's world through ``frames``
    frames: (layers, normals) as NumPy."""
    import jax.numpy as jnp

    from elevation_mapping_cupy_tpu import MapConfig, core, init_state
    from elevation_mapping_cupy_tpu.nn.traversability import default_weights

    c = lw.CONFIG
    cfg = MapConfig(resolution=c.resolution, map_length=c.map_length, max_ray_length=c.max_ray_length,
                    max_points=c.max_points)
    state, w = init_state(cfg), default_weights()
    for pts in lw.clouds(frames):
        state = core.update_pointcloud(state, jnp.asarray(pts), jnp.ones(cfg.max_points, bool), jnp.eye(3),
                                       jnp.asarray(lw.SENSOR_T), jnp.float32(0.0), jnp.float32(0.0), w, cfg)
    return np.asarray(state.layers), np.asarray(state.normal)


def _share_within(got, want):
    both_nan = np.isnan(got) & np.isnan(want)
    return (both_nan | (np.abs(np.nan_to_num(got, nan=1e9) - np.nan_to_num(want, nan=1e9)) <= ATOL)).mean()


def test_world_of_two_matches_jax_unsharded(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "4")  # 2 threads a worker
    r = lw.run(device="cpu", world=WORLD, frames=FRAMES)
    assert r["backend"] == "gloo" and len(r["reports"]) == WORLD
    assert all(len(rep["step_s"]) == FRAMES for rep in r["reports"])
    layers, normal = _jax_world(FRAMES)
    assert r["layers"].shape == layers.shape == (7, 512, 512)
    for i in range(layers.shape[0]):
        assert _share_within(r["layers"][i], layers[i]) >= MIN_SHARE, f"layer {i}"
    for i in range(3):
        assert _share_within(r["normal"][i], normal[i]) >= MIN_SHARE, f"normal {i}"
    assert 0.05 < float((layers[2] > 0.5).mean())

    monkeypatch.setattr(lw, "run", lambda *a, **k: r)
    assert lw.main(["--device", "cpu", "--world", str(WORLD), "--frames", str(FRAMES)]) == 0
    out = capsys.readouterr().out
    assert "512x512 cells" in out and f"over {WORLD} shards" in out
    assert "building A top: 1.2" in out
    assert "sharded world map ok" in out


def test_clouds_are_a_prefix_of_the_loop():
    """Fewer frames are the first scans of the same 12-frame loop."""
    few, full = lw.clouds(2), lw.clouds()
    assert len(full) == lw.FRAMES and len(few) == 2
    assert all(np.array_equal(a, b) for a, b in zip(few, full))
    assert full[0].shape == (lw.CONFIG.max_points, 3) and full[0].dtype == np.float32


def test_backend_and_world_are_checked():
    assert lw.default_backend(torch.device("cpu"), 8) == "gloo"
    if torch.cuda.device_count() < 8:
        assert lw.default_backend(torch.device("cuda"), 8) == "gloo"
    with pytest.raises(ValueError, match="one card a process"):
        lw.run(device="cpu", world=2, backend="nccl")
    with pytest.raises(ValueError, match="do not split over 3"):
        lw.run(device="cpu", world=3)


def test_a_failing_worker_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 0 exited 3"):
        lw.launch(2, torch.device("cpu"), "gloo", 1, worker_argv=[sys.executable, "-c", "import sys; sys.exit(3)"])


def test_worker_command_line_round_trips():
    kw = lw.parse_worker(["--worker", "1234", "1", "8", "/x", "--device", "cuda", "--backend", "gloo",
                          "--frames", "12"])
    assert kw == {"port": 1234, "rank": 1, "size": 8, "folder": "/x", "device": "cuda", "backend": "gloo",
                  "frames": 12}
