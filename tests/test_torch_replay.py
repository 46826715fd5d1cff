"""The port's log replay (``runtime/replay.py``) and its CLI
(``python -m elevation_mapping_cupy_torch.replay``), on the CPU, against the
JAX package's replay of the same log."""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from elevation_mapping_cupy_tpu import MapConfig as JaxConfig
from elevation_mapping_cupy_tpu import replay as jax_cli
from elevation_mapping_cupy_tpu.runtime.replay import replay as jax_replay

from elevation_mapping_cupy_torch import MapConfig
from elevation_mapping_cupy_torch import replay as cli
from elevation_mapping_cupy_torch.runtime.replay import LogWriter, read_log, replay

CFG_KW = dict(resolution=0.1, map_length=2.0, max_ray_length=0.5, max_points=1024)
LAYERS = ("elevation", "variance", "is_valid", "upper_bound")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture
def log_path(tmp_path):
    """tests/test_replay.py's 3-frame log, written by the port's LogWriter."""
    rng = np.random.default_rng(1234)
    w = LogWriter(["x", "y", "z"])
    for i in range(3):
        pts = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-0.1, 0.2, 500)
        w.add(pts, np.eye(3), np.array([0, 0, 0.5]), position=np.array([0.01 * i, 0, 0]), stamp=0.1 * i)
    path = str(tmp_path / "log.npz")
    w.save(path)
    return path


@pytest.fixture
def cfg_yaml(tmp_path):
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in CFG_KW.items()))
    return path


def test_replay_roundtrip_and_determinism(log_path):
    frames = list(read_log(log_path))
    assert len(frames) == 3 and frames[0]["points"].shape == (500, 3)
    assert frames[2]["stamp"] == pytest.approx(0.2) and frames[0]["channels"] == ["x", "y", "z"]
    snaps = replay(log_path, MapConfig(**CFG_KW), snapshot_layers=("elevation", "variance"), device="cpu")
    assert len(snaps) == 3
    assert np.isfinite(snaps[-1]["variance"]).all() and snaps[-1]["variance"].sum() > 0
    again = replay(log_path, MapConfig(**CFG_KW), snapshot_layers=("elevation", "variance"), device="cpu")
    np.testing.assert_array_equal(snaps[-1]["variance"], again[-1]["variance"])
    np.testing.assert_array_equal(snaps[-1]["elevation"], again[-1]["elevation"])


def test_replay_matches_jax_replay(log_path):
    """The same log through both packages' exact-march replays: every
    layer within the CLI's default atol of 2e-4 on jointly-finite cells,
    with the same finite cells."""
    got = replay(log_path, MapConfig(**CFG_KW), snapshot_layers=LAYERS, raycast_mode="exact", device="cpu")
    want = jax_replay(log_path, JaxConfig(**CFG_KW), snapshot_layers=LAYERS, raycast_mode="exact")
    report = cli.diff_snapshots(got, want, LAYERS, 2e-4)
    assert report["parity_ok"], report
    assert report["n_frames"] == 3
    assert all(l["min_finite_iou"] == 1.0 for l in report["layers"].values())


def test_replay_of_a_log_with_semantic_columns_matches_jax(tmp_path):
    """A 3-frame log with an rgb and one class channel: the frame's channel
    names reach input_pointcloud, the layers are grown on the first frame,
    and every snapshot matches the JAX replay (the packed colour layer bit
    for bit)."""
    rng = np.random.default_rng(77)
    w = LogWriter(["x", "y", "z", "rgb", "grass"])
    for i in range(3):
        pts = rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-0.1, 0.2, 500)
        packed = chip_smoke.pack_rgb(rng.integers(0, 256, (500, 3)))
        cloud = np.concatenate([pts, packed[:, None], rng.uniform(0, 1, (500, 1)).astype(np.float32)], 1)
        w.add(cloud, np.eye(3), np.array([0, 0, 0.5]), position=np.array([0.11 * i, 0, 0]), stamp=0.1 * i)
    path = str(tmp_path / "semantic_log.npz")
    w.save(path)
    layers = LAYERS + ("rgb", "grass")
    got = replay(path, MapConfig(**CFG_KW), snapshot_layers=layers, raycast_mode="exact", device="cpu")
    want = jax_replay(path, JaxConfig(**CFG_KW), snapshot_layers=layers, raycast_mode="exact")
    assert len(got) == len(want) == 3
    report = cli.diff_snapshots(got, want, LAYERS + ("grass",), 2e-4)
    assert report["parity_ok"], report
    for g, j in zip(got, want):
        np.testing.assert_array_equal(
            np.ascontiguousarray(g["rgb"]).view(np.uint32), np.ascontiguousarray(j["rgb"], np.float32).view(np.uint32)
        )
    assert np.count_nonzero(got[-1]["rgb"]) > 100 and np.count_nonzero(got[-1]["grass"]) > 100


def test_replay_refuses_mode_with_mapper(log_path):
    from elevation_mapping_cupy_torch.mapper import ElevationMap

    with pytest.raises(ValueError, match="mapper"):
        replay(log_path, MapConfig(**CFG_KW), mapper=ElevationMap(MapConfig(**CFG_KW), device="cpu"),
               raycast_mode="exact")


def test_cli_out_diff_and_device(tmp_path, log_path, cfg_yaml, capsys):
    """--log/--out/--diff-against/--device cpu: a self-diff passes (exit 0),
    a perturbed reference fails (exit 1), and the JAX CLI's dump of the
    same log passes the port's diff."""
    out = str(tmp_path / "mine.npz")
    base = ["--log", log_path, "--config", cfg_yaml, "--layers", "elevation,is_valid", "--device", "cpu"]
    assert cli.main(base + ["--out", out]) == 0
    assert '"n_frames": 3' in capsys.readouterr().out
    assert cli.main(base + ["--diff-against", out, "--summary-only"]) == 0

    ref = dict(np.load(out, allow_pickle=True))
    ref["f1_elevation"] = ref["f1_elevation"] + 0.05
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **ref)
    assert cli.main(base + ["--diff-against", bad, "--summary-only"]) == 1
    assert '"parity_ok": false' in capsys.readouterr().out

    jax_out = str(tmp_path / "jax.npz")
    assert jax_cli.main(["--log", log_path, "--config", cfg_yaml, "--out", jax_out, "--layers", "elevation,is_valid"]) == 0
    assert cli.main(base + ["--diff-against", jax_out]) == 0


def test_cli_refusals(tmp_path, log_path, cfg_yaml, monkeypatch, capsys):
    """What the CLI cannot do here fails with a message that says why: no
    log, a YAML config without PyYAML, and the default device without a
    card."""
    with pytest.raises(SystemExit):
        cli.main(["--config", cfg_yaml])
    assert "--log is required" in capsys.readouterr().err

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises ImportError
    with pytest.raises(SystemExit) as e:
        cli.main(["--log", log_path, "--config", cfg_yaml, "--device", "cpu"])
    assert e.value.code == 2 and "needs PyYAML" in capsys.readouterr().err
    monkeypatch.delitem(sys.modules, "yaml")

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--log", log_path, "--config", cfg_yaml])


def raw_dump(path, n_frames=3, n_points=600, seed=21):
    """A RAW PointCloud2-style dump: x, y, z, a pad and intensity per 20-byte
    record, a few records with a NaN coordinate, one frame without its
    position."""
    rng = np.random.default_rng(seed)
    arrays = {"n_frames": np.int64(n_frames), "channels": np.array(["x", "y", "z", "intensity"], dtype=object)}
    for i in range(n_frames):
        rec = np.zeros((n_points, 5), np.float32)
        rec[:, :2] = rng.uniform(-0.9, 0.9, (n_points, 2))
        rec[:, 2] = rng.uniform(-0.1, 0.2, n_points)
        rec[:, 4] = rng.uniform(0, 1, n_points)
        rec[rng.integers(0, n_points, 5), rng.integers(0, 3, 5)] = np.nan
        arrays[f"f{i}_data"] = rec.view(np.uint8).reshape(-1)
        arrays[f"f{i}_n_points"] = np.int64(n_points)
        arrays[f"f{i}_point_step"] = np.int64(20)
        arrays[f"f{i}_offsets"] = np.array([0, 4, 8, 16], np.int64)
        arrays[f"f{i}_R"] = np.eye(3, dtype=np.float32)
        arrays[f"f{i}_t"] = np.array([0.02 * i, 0, 0.5], np.float32)
        arrays[f"f{i}_stamp"] = np.float64(0.1 * i)
        if i != 1:
            arrays[f"f{i}_position"] = np.array([0.02 * i, 0, 0], np.float32)
    np.savez(path, **arrays)
    return path


def test_from_pointcloud2_matches_jax(tmp_path, cfg_yaml, capsys):
    """A seeded raw dump converted by both packages' converters, and by both
    CLIs with --from-pointcloud2 --save-log: the logs hold the same arrays;
    the port's CLI then replays its converted log like the JAX CLI does."""
    raw = raw_dump(str(tmp_path / "raw.npz"))
    assert cli.convert_pointcloud2_npz(raw, str(tmp_path / "mine.npz")) == 3
    assert jax_cli.convert_pointcloud2_npz(raw, str(tmp_path / "theirs.npz")) == 3

    def same_logs(a, b):
        with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
                if x[k].dtype == object:
                    assert x[k].tolist() == y[k].tolist(), k
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    same_logs(str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz"))
    frames = list(read_log(str(tmp_path / "mine.npz")))
    assert [f["points"].shape[1] for f in frames] == [4, 4, 4]
    assert all(np.isfinite(f["points"]).all() and 590 <= len(f["points"]) < 600 for f in frames)

    base = ["--from-pointcloud2", raw, "--config", cfg_yaml, "--layers", "elevation,is_valid"]
    mine_out, theirs_out = str(tmp_path / "mine_out.npz"), str(tmp_path / "theirs_out.npz")
    assert cli.main(base + ["--save-log", str(tmp_path / "cli_mine.npz"), "--out", mine_out, "--device", "cpu"]) == 0
    assert '"converted"' in capsys.readouterr().out
    assert jax_cli.main(base + ["--save-log", str(tmp_path / "cli_theirs.npz"), "--out", theirs_out]) == 0
    same_logs(str(tmp_path / "cli_mine.npz"), str(tmp_path / "cli_theirs.npz"))
    same_logs(str(tmp_path / "cli_mine.npz"), str(tmp_path / "mine.npz"))
    assert cli.main(["--log", str(tmp_path / "cli_mine.npz"), "--config", cfg_yaml, "--layers", "elevation,is_valid",
                     "--device", "cpu", "--diff-against", theirs_out]) == 0
    with pytest.raises(SystemExit) as e:
        cli.main(["--from-pointcloud2", raw])
    assert e.value.code == 2 and "--save-log" in capsys.readouterr().err
