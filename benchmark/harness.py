"""What every cell of the benchmark shares: the manifest and the files it
names, host spans, the traced window, the device's description and the
result line.

Everything particular to a configuration, a traffic mix, a way of driving
the program or a per-layer metric sits in a file of its own, found by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (see ``map_config``);
- ``traffic/<mix>.json``: a traffic mix and the driver that runs it;
- ``drivers/<driver>.py``: ``run(ctx) -> record`` and ``judge(ctx, record)``;
- ``metrics/<metric>.py``: ``read(record) -> float or None``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# the module names that may not be loaded in a run (compared by their top
# level, whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "elevation_mapping_cupy_tpu")
# the program's build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, "build", "benchmark_cache")

__all__ = [
    "Context", "Spans", "Tracer", "load_json", "manifest", "workload", "config_file", "traffic_file",
    "load_driver", "load_metric", "cell_metrics", "forbidden_loaded", "setup_environment", "percentile",
    "median", "union_seconds", "idle_gaps", "idle_by_label", "breakdown", "k1_bytes", "k1_roofline",
    "device_seconds", "device_info", "result_line", "finite", "map_config_fields", "weight_arrays",
]


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(path: str = MANIFEST) -> Dict:
    return load_json(path)


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return _load(os.path.join(BENCH_DIR, "drivers", f"{name}.py"), f"benchmark_driver_{name}")


def load_metric(name: str):
    return _load(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), "benchmark_metric_" + name.replace(".", "_"))


def cell_metrics(man: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """(end-to-end, per-layer) metric entries that a cell reports: those
    that list it under ``workloads``, and those without the key, which every
    cell reports (a per-layer metric without it: every cell that reports
    the end-to-end metric it moves)."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def setup_environment() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, before torch or the program is imported."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def median(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 50) if len(values) else None


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its files and the run's arguments."""

    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    process_start: float
    spans: "Spans"

    def say(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


class Spans:
    """Host spans of the benchmark's calls into the program's layers:
    (name, start, end, attributes), ``time.perf_counter`` seconds. While a
    trace is on, each span is also a ``record_function`` range, so that the
    device timeline can be read by what the host was doing."""

    def __init__(self):
        self.items: List[Tuple[str, float, float, Dict]] = []
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if self.tracing:
            from torch.profiler import record_function

            with record_function("bench." + name):
                t0 = time.perf_counter()
                try:
                    yield attrs
                finally:
                    self.items.append((name, t0, time.perf_counter(), dict(attrs, traced=True)))
        else:
            t0 = time.perf_counter()
            try:
                yield attrs
            finally:
                self.items.append((name, t0, time.perf_counter(), attrs))

    def of(self, name: str, traced: Optional[bool] = None) -> List[Tuple[str, float, float, Dict]]:
        return [s for s in self.items
                if s[0] == name and (traced is None or bool(s[3].get("traced")) == traced)]


class Tracer:
    """``torch.profiler`` over part of a window. ``start`` and ``stop``
    synchronise the device, so that the trace holds exactly the work issued
    between them; ``stop`` returns the trace as plain lists: device
    operations (name, start, end) in host ``perf_counter`` seconds, the
    benchmark's own ranges, and the shape and active points of every launch
    of the program's kernel K1 (recorded by wrapping its entry point, as the
    smoke test's ``k1_shapes`` does; the masks are counted after ``stop``)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.k1: List[Tuple] = []
        self._k1_entry = None

    def _wrap_k1(self) -> None:
        from elevation_mapping_cupy_torch.ops import cuda_scatter

        launch = self._k1_entry = cuda_scatter.scatter_add_streams
        k1 = self.k1

        def recording(idx, mask, values, n_cells):
            k1.append((*values.shape, n_cells, mask))
            return launch(idx, mask, values, n_cells)

        cuda_scatter.scatter_add_streams = recording

    def _unwrap_k1(self) -> List[Tuple[int, int, int, int, int]]:
        from elevation_mapping_cupy_torch.ops import cuda_scatter

        cuda_scatter.scatter_add_streams = self._k1_entry
        out = [(b, k, n, c, int(mask.sum())) for b, k, n, c, mask in self.k1]
        self.k1 = []
        return out

    @staticmethod
    def warm() -> None:
        """One empty trace, so that the profiler's own start-up is set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._wrap_k1()
        self.prof = profile(activities=acts)
        self.prof.start()
        with record_function("bench.anchor"):
            self.anchor = time.perf_counter_ns()
        self.spans.tracing = True
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.tracing = False
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # "clears events at the end of each cycle"
            self.prof.stop()
        k1 = self._unwrap_k1()
        events = self.prof.profiler.kineto_results.events()
        anchor = [e for e in events if e.name() == "bench.anchor" and e.device_type().name == "CPU"]
        offset = (anchor[0].start_ns() - self.anchor) if anchor else 0
        device, ranges = [], []
        for e in events:
            kind = e.device_type().name
            t0 = (e.start_ns() - offset) / 1e9
            t1 = t0 + e.duration_ns() / 1e9
            if kind == "CUDA":
                if e.is_user_annotation() or e.name().startswith("bench."):
                    continue
                device.append((e.name(), t0, t1))
            elif kind == "CPU" and e.name().startswith("bench.") and e.name() != "bench.anchor":
                ranges.append((e.name()[len("bench."):], t0, t1))
        device.sort(key=lambda d: d[1])
        self.prof = None
        return {"window": (self.t0, self.t1), "device": device, "ranges": ranges, "k1": k1,
                "anchor_found": bool(anchor)}


def union_seconds(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(device: Sequence[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no device operation ran."""
    gaps, end = [], lo
    for _, a, b in sorted(device, key=lambda d: d[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def idle_by_label(device: Sequence[Tuple[str, float, float]], ranges: Sequence[Tuple[str, float, float]],
                  lo: float, hi: float) -> Dict[str, float]:
    """Idle device seconds in [lo, hi], each moment given to the innermost
    benchmark range the host was in then (the latest-started of those open,
    for nested ranges), or to ``outside_any_span``."""
    import heapq

    marks = sorted([(max(a, lo), 0, -max(a, lo), i) for i, (_, a, b) in enumerate(ranges) if b > lo and a < hi]
                   + [(min(b, hi), 1, 0.0, i) for i, (_, a, b) in enumerate(ranges) if b > lo and a < hi])
    segments, open_, closed, t = [], [], set(), lo
    for when, kind, neg_start, i in marks + [(hi, 2, 0.0, -1)]:
        while open_ and open_[0][1] in closed:
            heapq.heappop(open_)
        if when > t:
            segments.append((t, when, ranges[open_[0][1]][0] if open_ else "outside_any_span"))
            t = when
        if kind == 0:
            heapq.heappush(open_, (neg_start, i))
        elif kind == 1:
            closed.add(i)
    out: Dict[str, float] = {}
    gaps = idle_gaps(device, lo, hi)
    j = 0
    for a, b, label in segments:
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            over = min(b, gaps[k][1]) - max(a, gaps[k][0])
            if over > 0:
                out[label] = out.get(label, 0.0) + over
            k += 1
    return out


def breakdown(trace: Dict, lo: float, hi: float) -> Dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, over [lo, hi]: at most 10 entries each."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace["device"]:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_op[name[:80]] = by_op.get(name[:80], 0.0) + (b - a)
    by_gap = idle_by_label(trace["device"], trace["ranges"], lo, hi)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


# the device's memory rate: H100 SXM, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
K1_KERNELS = ("scatter_add_private_kernel", "scatter_add_global_kernel")


def k1_bytes(b: int, k: int, n: int, n_cells: int, active: int) -> int:
    """The bytes a K1 launch has to move: each point's index and mask flag
    read once, each active point's K values read once, the output written
    once (the smoke test's count)."""
    return b * n * 5 + active * 4 * k + b * k * n_cells * 4


def k1_roofline(trace: Optional[Dict]) -> Optional[float]:
    """K1's share of its memory roofline in the traced window, in %: the
    least time its launches' bytes take at the device's rate over the time
    its launches took on the device (each kernel with the zero fill of its
    output, the memset issued just before it). Means per launch, so that a
    record the tracer drops does not skew it."""
    if not trace or not trace["k1"]:
        return None
    dev = trace["device"]
    times = []
    for i, (name, a, b) in enumerate(dev):
        if any(k in name for k in K1_KERNELS):
            fill = dev[i - 1] if i > 0 and dev[i - 1][0].startswith("Memset") else None
            times.append((b - a) + ((fill[2] - fill[1]) if fill else 0.0))
    if not times:
        return None
    bound = [k1_bytes(*launch) / HBM_BYTES_PER_S for launch in trace["k1"]]
    return 100.0 * (sum(bound) / len(bound)) / (sum(times) / len(times))


def device_seconds(trace: Optional[Dict]) -> Tuple[int, float]:
    """(operations, their summed device seconds) in the traced window."""
    if not trace:
        return 0, 0.0
    lo, hi = trace["window"]
    ops = [(a, b) for _, a, b in trace["device"] if b > lo and a < hi]
    return len(ops), sum(min(b, hi) - max(a, lo) for a, b in ops)


def device_info(peak: int) -> Dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Tuple[float, str]], device: Dict,
                checks: Dict[str, Dict[str, float]], breakdown_: Optional[Dict] = None) -> str:
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = checks
    return json.dumps(out, allow_nan=False)


def finite(x: float) -> bool:
    return x is not None and math.isfinite(x)


# the configuration fields that the program holds as tuples
_TUPLE_FIELDS = ("semantic_layers", "pointcloud_channel_fusions", "image_channel_fusions")


def map_config_fields(cfg: Dict) -> Dict:
    """A configuration file's ``map_config`` block as keyword arguments of
    the program's ``MapConfig`` (JSON lists back to tuples)."""
    out = dict(cfg["map_config"])
    for k in _TUPLE_FIELDS:
        if k in out:
            out[k] = tuple(tuple(x) if isinstance(x, list) else x for x in out[k])
    return out


def weight_arrays(cfg: Dict) -> Dict:
    """The traversability CNN's weights the configuration names: a file of
    the repository (read here, and handed to the program and the reference
    alike), or all zeros."""
    import numpy as np

    spec = cfg["weights"]
    if spec.get("zeros"):
        z = np.zeros((4, 1, 3, 3), np.float32)
        return {"w1": z, "w2": z, "w3": z, "w_out": np.zeros((1, 12, 1, 1), np.float32)}
    with np.load(os.path.join(ROOT, spec["file"])) as f:
        return {k: np.asarray(f[k], np.float32) for k in ("w1", "w2", "w3", "w_out")}
