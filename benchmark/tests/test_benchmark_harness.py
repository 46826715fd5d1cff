"""The harness's own arithmetic: the device timeline's union and gaps, the
labels of idle time, K1's roofline, the result line, the command's refusal
without a card, and a whole traced run of each cell on the card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness as H
from benchmark import run as RUN


def _trace(device, ranges=(), k1=(), window=(0.0, 10.0)):
    return {"window": window, "device": sorted(device, key=lambda d: d[1]), "ranges": list(ranges), "k1": list(k1)}


def test_union_and_gaps_of_overlapping_operations():
    dev = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0), ("d", 9.5, 12.0)]
    assert H.union_seconds([(a, b) for _, a, b in dev], 0.0, 10.0) == pytest.approx(4.5)
    assert H.idle_gaps(dev, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]


def test_idle_time_is_labelled_by_the_innermost_range():
    tr = _trace([("k", 1.0, 2.0)], ranges=[("step", 0.0, 10.0), ("step.inner", 2.5, 5.0)])
    bd = H.breakdown(tr, 0.0, 10.0)
    gaps = dict(bd["idle_gaps"])
    assert gaps["step"] == pytest.approx(1.0 + 0.5 + 5.0) and gaps["step.inner"] == pytest.approx(2.5)
    tr = _trace([("k", 1.0, 2.0)], ranges=[("a", 0.0, 3.0)])
    assert dict(H.breakdown(tr, 0.0, 10.0)["idle_gaps"]) == pytest.approx({"a": 2.0, "outside_any_span": 7.0})
    assert bd["device_ops"] == [["k", 1.0]]


def test_breakdown_keeps_ten_entries():
    dev = [(f"op{i}", float(i), i + 0.5) for i in range(20)]
    bd = H.breakdown(_trace(dev, window=(0.0, 20.0)), 0.0, 20.0)
    assert len(bd["device_ops"]) == 10 and len(bd["idle_gaps"]) <= 10


def test_k1_roofline_counts_the_zero_fill_and_the_launch_bytes():
    b, k, n, cells, active = 1, 2, 1000, 40000, 800
    need = H.k1_bytes(b, k, n, cells, active) / H.HBM_BYTES_PER_S
    dev = [("Memset (Device)", 0.0, need), ("scatter_add_private_kernel", need, 4 * need)]
    assert H.k1_roofline(_trace(dev, k1=[(b, k, n, cells, active)])) == pytest.approx(25.0)
    assert H.k1_roofline(_trace([("other", 0.0, 1.0)], k1=[(b, k, n, cells, active)])) is None
    assert H.k1_roofline(_trace(dev)) is None


def test_result_line_has_the_contract_keys_and_checks_last():
    line = H.result_line(True, 10, 0, {"setup_s": (1.5, "s")}, {"platform": "gpu"},
                         {"final_mismatch": {"value": 0.0, "limit": 0.01}}, {"device_ops": [], "idle_gaps": []})
    obj = json.loads(line)
    assert list(obj) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert obj["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}


def test_the_command_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "datagen_default.b8_ep8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=H.ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if proc.returncode == 0:
        pytest.skip("this machine has a card")
    assert proc.stdout.strip() == "" and "CUDA" in proc.stderr


def test_traced_metrics_read_a_shrunk_run():
    from benchmark.tests.small import context

    ctx = context("anymal_deployed.lidar_10hz", 2**32 + 5, seconds=2.0, trace=True)
    correct, rec, metrics, checks, _ = RUN.execute(ctx)
    assert correct and rec["trace"] is not None and rec["trace"]["anchor_found"]
    assert metrics["mapper_enqueue_ms.robot"][0] > 0
    assert all(m in {e["name"] for e in H.manifest()["per_layer"]} for m in metrics)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in H.manifest()["workloads"]])
def test_each_cell_runs_traced_on_the_card(card, name):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 3),
                           "--seconds", "6", "--trace", "1"], cwd=H.ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    obj = json.loads(proc.stdout.strip().splitlines()[-1])
    assert obj["correct"] and obj["device"]["busy_s"] > 0 and obj["metrics"]
    for m, v in obj["metrics"].items():
        if m.startswith("k1_roofline") or m.startswith("device_idle_share"):
            assert 0 <= v["value"] <= 100, (m, v)
