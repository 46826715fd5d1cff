"""The cell datagen_exact.b64_ep8: its configuration against the port's,
its traffic against b64_ep8's, its plain reference (the dense march of
``reference/exact.py``) against the program, a shrunk window judged as a
run judges it, and its per-layer metrics on synthetic records."""

import ast
import collections
import copy
import dataclasses
import os
import time

import pytest
import torch

from benchmark import exact_march as K2
from benchmark import harness as H
from benchmark import run as RUN

CELL = "datagen_exact.b64_ep8"
MAN = H.manifest()


def _shrunk():
    """The cell at the tests' size: a 52x52 map, 4096 points a map, 2
    maps, episodes of 3 steps."""
    cell = H.workload(MAN, CELL)
    cfg = copy.deepcopy(H.config_file(MAN, cell["config"]))
    tr = copy.deepcopy(H.traffic_file(cell["traffic"]))
    cfg["map_config"]["map_length"] = 2.0
    tr.update(points=4096, maps=2, pool_episodes=2, episode_steps=3)
    return cfg, tr


def test_datagen_exact_is_the_default_config_with_the_exact_march():
    from elevation_mapping_cupy_torch import MapConfig

    body = H.config_file(MAN, "datagen_exact")
    want = MapConfig(max_points=100000, raycast_mode="exact")
    assert MapConfig(**H.map_config_fields(body)) == want
    assert dataclasses.asdict(MapConfig(**H.map_config_fields(body))) == dataclasses.asdict(want)
    default = H.config_file(MAN, "datagen_default")
    assert {k: v for k, v in body["map_config"].items() if k != "raycast_mode"} == \
        {k: v for k, v in default["map_config"].items() if k != "raycast_mode"}
    assert body["weights"] == {"zeros": True} and body["reduced"] == []
    assert set(default["assumed"]) <= set(body["assumed"])


def test_traffic_is_b64_ep8_but_for_its_driver_and_limits():
    mine, base = H.traffic_file("b64_ep8_exact"), H.traffic_file("b64_ep8")
    assert mine["driver"] == "batched_steps_exact"
    strip = lambda d: {k: v for k, v in d.items() if k not in ("driver", "limits")}  # noqa: E731
    assert strip(mine) == strip(base) and set(mine["limits"]) == set(base["limits"])


def test_the_exact_reference_imports_neither_jax_nor_the_program_and_keeps_tf32_off():
    path = os.path.join(H.BENCH_DIR, "reference", "exact.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "elevation_mapping_cupy_tpu",
                                                         "elevation_mapping_cupy_torch")]
    assert "allow_tf32 = True" not in open(path).read()
    assert not torch.backends.cuda.matmul.allow_tf32


def test_the_reference_params_resolve_the_exact_cleanup():
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.ops.raycast import resolve_exact_impl, resolve_raycast_mode

    from benchmark.reference.params import Params

    body = H.config_file(MAN, "datagen_exact")
    p, cfg = Params(body["map_config"]), MapConfig(**H.map_config_fields(body))
    assert p.cleanup_mode() == resolve_raycast_mode(cfg) == "exact"
    assert (p.cell_n, p.n_ray_steps) == (cfg.cell_n, cfg.n_ray_steps) == (202, 70)
    assert resolve_exact_impl(cfg) == "gated"


def test_a_shrunk_window_agrees_and_records_k2():
    cfg, tr = _shrunk()
    ctx = RUN.context(CELL, 2**31 + 7, 1.0, False, "cpu", time.perf_counter(), None, cfg, tr)
    correct, rec, metrics, checks, _ = RUN.execute(ctx)
    assert correct and checks["final_mismatch"]["value"] <= 1e-3, checks
    assert rec["attempted"] > 0 and rec["failed"] == 0 and rec["k2"] == []  # untraced: nothing recorded
    assert set(metrics) == {"maps_per_s", "setup_s"}


def _march_broken(kind: str):
    """The program's K2 entry broken underneath: ``off`` changes no cell,
    ``rolled`` hands each map the next map's results."""
    from elevation_mapping_cupy_torch.ops import cuda_march

    entry = cuda_march.exact_march

    def broken(*args, **kw):
        res = entry(*args, **kw)
        if kind == "off":
            return res._replace(dec=torch.zeros_like(res.dec), hits=torch.zeros_like(res.hits),
                                ubmin=torch.full_like(res.ubmin, float("inf")))
        return res._replace(**{f: getattr(res, f).roll(1, 0) for f in ("dec", "hits", "ubmin")})

    return broken


@pytest.mark.parametrize("kind", ["off", "rolled"])
def test_a_broken_exact_cleanup_fails_the_limit(monkeypatch, kind):
    """At the cell's density (here 20000 points on the 52x52 map, about 7 a
    cell) the window gives the cleanup nothing to change: a march that
    changes no cell, or hands each map the next map's cells, leaves the
    episodes' ends as they were. The probe after the window catches both,
    and the cell's check fails."""
    from elevation_mapping_cupy_torch.ops import cuda_march

    cfg, tr = _shrunk()
    tr["points"] = 20000
    monkeypatch.setattr(cuda_march, "exact_march", _march_broken(kind))
    ctx = RUN.context(CELL, 2**31 + 11, 1.0, False, "cpu", time.perf_counter(), None, cfg, tr)
    driver = H.load_driver(tr["driver"])
    rec = driver.run(ctx)
    limit = tr["limits"]["final_mismatch"]
    ends, probes = driver.mismatches(ctx, rec)
    assert ends <= limit < 10 * limit < probes
    assert driver.judge(ctx, rec) == {"final_mismatch": probes}


def test_the_control_fails_the_limit():
    from benchmark import control

    cfg, tr = _shrunk()
    res = control.readings(CELL, 2**31 + 3, 1.0, "cpu", config=cfg, traffic=tr)
    limit = H.traffic_file("b64_ep8_exact")["limits"]["final_mismatch"]
    assert res["reference"]["final_mismatch"] < limit < res["control_bf16"]["final_mismatch"]


@pytest.mark.parametrize("shape", [(1, 100000, 202 * 202, 26 * 26), (64, 100000, 202 * 202, 26 * 26),
                                   (1, 10, 4, 0), (3, 7, 16, 0)])
def test_k2_bytes_count_per_map(shape):
    """The benchmark's count of K2's bytes is chip_smoke's, and a batch's is
    its maps' sum."""
    import chip_smoke

    assert K2.k2_bytes(*shape) == chip_smoke.march_bytes(*shape)
    assert K2.k2_bytes(*shape) == shape[0] * K2.k2_bytes(1, *shape[1:])


def test_k2_roofline_pairs_each_march_with_its_initialisation():
    trace = {"window": (10.0, 20.0), "device": [
        ("(anonymous namespace)::init_outputs_kernel(...)", 11.0, 11.0 + 1e-6),
        ("void (anonymous namespace)::exact_march_kernel<16>(...)", 11.1, 11.1 + 3e-6),
        ("elementwise", 12.0, 12.5),
        ("void (anonymous namespace)::exact_march_kernel<16>(...)", 13.0, 13.0 + 4e-6),
    ]}
    launches = [(11.0, 1, 10, 4, 0), (9.0, 1, 10, 4, 0)]  # the second outside the window
    got = K2.k2_roofline(trace, launches)
    want = 100.0 * (K2.k2_bytes(1, 10, 4, 0) / H.HBM_BYTES_PER_S) / ((4e-6 + 4e-6) / 2)
    assert got == pytest.approx(want)
    assert K2.k2_roofline(trace, []) is None and K2.k2_roofline(None, launches) is None
    assert K2.k2_roofline({"window": (0, 1), "device": [("x", 0.1, 0.2)]}, launches) is None


tracing = pytest.importorskip("elevation_mapping_cupy_torch.tracing")


def _span(sid, name, t0, ms, parent=None, stream=None, **attrs):
    s = tracing.span(name, **attrs)
    s.sid, s.rid, s.thread = sid, 0, 1
    s.parent = parent
    s.t0_ns = int(round(t0 * 1e9))
    s.t1_ns = s.t0_ns + int(round(ms * 1e6))
    s._stream_ms = stream
    return s


def test_the_exact_span_metrics(monkeypatch):
    rec = {"window_start": 100.0, "window_end": 115.5, "trace": {"window": (110.0, 115.0)}, "maps": 64}
    items = []
    for i, t in enumerate((101.0, 102.0, 103.0, 111.0, 112.0)):
        step = _span(10 * i + 1, "batch.update", t, 20.0, maps=64)
        items += [step, _span(10 * i + 2, "core.fusion", t, 1.0, step.sid, 0.5),
                  _span(10 * i + 3, "raycast.exact", t + 0.001, 2.0 + i, step.sid, 8.0 + i)]
    monkeypatch.setattr(tracing, "_ring", collections.deque(items, maxlen=tracing.RING_SIZE))
    issue = H.load_metric("exact_issue_ms_per_step.datagen_exact").read(rec)
    stream = H.load_metric("exact_stream_ms_per_map.datagen_exact").read(rec)
    assert issue == pytest.approx(3.0)  # untraced steps: 2, 3, 4 ms
    assert stream == pytest.approx((11.0 + 12.0) / 128)
    # a program without the span (one that cleans up map by map) gives None
    monkeypatch.setattr(tracing, "_ring", collections.deque([s for s in items if s.name != "raycast.exact"],
                                                            maxlen=tracing.RING_SIZE))
    assert H.load_metric("exact_issue_ms_per_step.datagen_exact").read(rec) is None
    assert H.load_metric("exact_stream_ms_per_map.datagen_exact").read(rec) is None
    assert H.load_metric("k2_roofline.datagen_exact").read(dict(rec, trace=None)) is None
