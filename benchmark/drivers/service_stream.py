"""Driver ``service_stream``: a robot's mapping service fed by a LiDAR on a
fixed schedule, an open loop.

Set-up makes every frame of the window from the seed (raw PointCloud2
records on the host), builds the program's ``MappingService`` with the
configuration's timers, the native frame ring and one publisher, and warms
every shape on a throwaway service. In the window a producer thread pushes
frame k into ``enqueue_raw_pointcloud`` at its due time t0 + k / rate; this
thread calls ``update_pose`` at the same rate and, whenever frames wait,
``spin_once`` followed by a synchronise. A frame's latency runs from its due
time to the end of that synchronise.

Every call into the service's map is logged in order (poses, fused frames,
the variance and time timers, publishes), so that the reference replays
the window on a fresh map of its own and holds every publish and the final
map to it.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness as H
from benchmark.reference import replay as R
from benchmark.reference import update as U
from benchmark.reference.params import Params
from benchmark.traffic import lidar_scene

OFFSETS = [0, 4, 8]      # byte offsets of x, y, z in a record
CHANNELS = ["x", "y", "z"]


def _build(ctx, publish=None):
    """A fresh mapping service as the configuration deploys it, with the
    raw frame ring and the traffic's publisher."""
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.mapper import ElevationMap
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.runtime.service import MappingService

    cfg = MapConfig(**H.map_config_fields(ctx.config))
    mapper = ElevationMap(cfg, weights=TravFilter(**H.weight_arrays(ctx.config)), device=ctx.device)
    svc = MappingService.from_settings(cfg, ctx.config["extras"], mapper=mapper, device=ctx.device)
    svc.enable_raw_ingest(capacity=ctx.traffic["ring_capacity"])
    pub = ctx.traffic["publish"]
    svc.add_publisher(pub["name"], pub["layers"], pub["fps"], publish or (lambda out: None))
    return svc


def _sync(ctx) -> None:
    if ctx.device != "cpu":
        torch.cuda.synchronize()


def _push(svc, tr, records, poses, k) -> bool:
    R_, t, _ = poses[k]
    return svc.enqueue_raw_pointcloud(records[k].view(np.uint8).reshape(-1), tr["points"], tr["point_step"],
                                      OFFSETS, CHANNELS, R_, t, stamp=float(k))


def _instrument(svc, spans: H.Spans, events: List, accepted: List[int]):
    """Logs and spans every call the service makes into its map."""
    m = svc.mapper
    fused = [0]

    def wrap(name, fn, event):
        def call(*a, **kw):
            ev = event()
            if ev is not None:
                events.append(ev)
            with spans.span("mapper." + name):
                return fn(*a, **kw)
        setattr(m, name, call)

    def cloud():
        k = accepted[fused[0]]
        fused[0] += 1
        return ("cloud", k)

    wrap("input_pointcloud", m.input_pointcloud, cloud)
    wrap("update_variance", m.update_variance, lambda: ("variance",))
    wrap("update_time", m.update_time, lambda: ("time",))
    wrap("get_layers", m.get_layers, lambda: None)
    wrap("move_to", m.move_to, lambda: None)
    return fused


def run(ctx: H.Context) -> Dict:
    tr = ctx.traffic
    rate = tr["rate_hz"]
    period = 1.0 / rate
    n = int(round(ctx.seconds * rate))
    t_in = time.perf_counter()
    records, poses = lidar_scene.make_frames(ctx.seed, n, tr, ctx.device)
    t_warm = time.perf_counter()

    # warm-up: the cell's own shapes on a throwaway service
    warm = _build(ctx)
    for k in range(tr["warmup_frames"]):
        R_, _, pos = poses[k]
        warm.update_pose(pos, R_)
        if not _push(warm, tr, records, poses, k):
            raise RuntimeError("the warm-up service's ring rejected a frame")
        warm.spin_once(now=time.monotonic())
        _sync(ctx)
    del warm
    ctx.say(f"set-up: imports and CUDA {t_in - ctx.process_start:.3f} s, {n} frames {t_warm - t_in:.3f} s, "
            f"build and warm-up {time.perf_counter() - t_warm:.3f} s")
    tracer = H.Tracer(ctx.spans)
    if ctx.trace and ctx.device != "cpu":
        H.Tracer.warm()

    published: List[Dict[str, np.ndarray]] = []
    events: List = []
    accepted: List[int] = []

    def keep(out):
        events.append(("publish", len(published)))
        published.append(out)

    svc = _build(ctx, keep)
    fused = _instrument(svc, ctx.spans, events, accepted)
    arrivals: "queue.SimpleQueue[int]" = queue.SimpleQueue()
    pushed_at = [math.nan] * n
    ready = [0]           # frames the ring holds or has handed out
    go = threading.Event()
    t0_box = [0.0]

    def producer():
        go.wait()
        t0 = t0_box[0]
        for k in range(n):
            due = t0 + k * period
            while True:
                wait = due - time.perf_counter()
                if wait <= 0:
                    break
                time.sleep(wait)
            accepted.append(k)   # before the push: the consumer may pop it at once
            ok = _push(svc, tr, records, poses, k)
            pushed_at[k] = time.perf_counter()
            if ok:
                ready[0] += 1
            else:
                accepted.pop()
            arrivals.put(k)

    th = threading.Thread(target=producer, name="lidar-producer", daemon=True)
    th.start()
    _sync(ctx)
    # the traced part is the window's last seconds: the profiler's stop,
    # which holds the interpreter for seconds, comes after the last step
    trace_lo = ctx.seconds - min(5.0, ctx.seconds / 3)
    trace = None
    done_at = [math.nan] * n
    arrived = next_pose = 0
    t0 = time.perf_counter() + 0.05
    t0_box[0] = t0
    window_start = t0
    go.set()
    try:
        while arrived < n or fused[0] < ready[0]:
            now = time.perf_counter()
            if ctx.trace and trace is None and tracer.prof is None and now - t0 >= trace_lo:
                tracer.start()
            while next_pose < n and t0 + next_pose * period <= now:
                R_, _, pos = poses[next_pose]
                events.append(("pose", next_pose))
                with ctx.spans.span("service.update_pose"):
                    svc.update_pose(pos, R_)
                next_pose += 1
            if fused[0] < ready[0]:
                before = fused[0]
                with ctx.spans.span("service.spin_once") as attrs:
                    svc.spin_once(now=time.monotonic())
                    _sync(ctx)
                    attrs["frames"] = fused[0] - before
                end = time.perf_counter()
                for c in range(before, fused[0]):
                    done_at[accepted[c]] = end
                continue
            wait = (t0 + next_pose * period - time.perf_counter()) if next_pose < n else 0.05
            try:
                arrivals.get(timeout=max(wait, 0.0))
                arrived += 1
            except queue.Empty:
                pass
            while True:
                try:
                    arrivals.get_nowait()
                    arrived += 1
                except queue.Empty:
                    break
        if tracer.prof is not None:
            trace = tracer.stop()
        _sync(ctx)
        window_end = time.perf_counter()
    finally:
        go.set()
        th.join(timeout=60)
    if th.is_alive():
        raise RuntimeError("the producer thread did not end")

    due = t0 + np.arange(n) * period
    lat = np.where(np.isnan(done_at), window_end, done_at) - due
    late = np.asarray(pushed_at) - due
    ctx.say(f"producer lateness: median {np.nanmedian(late) * 1e3:.3f} ms, p95 "
            f"{np.nanpercentile(late, 95) * 1e3:.3f} ms, max {np.nanmax(late) * 1e3:.3f} ms over {n} frames")
    st = svc.mapper.state
    final = {
        "layers": st.layers.detach().cpu(), "normal": st.normal.detach().cpu(),
        "scalars": torch.cat([st.center, st.mean_error[None], st.additive_mean_error[None]]).detach().cpu(),
    }
    del svc, st
    return {
        "window_start": window_start,
        "window_end": window_end,
        "attempted": n,
        "failed": int(np.isnan(done_at).sum()),
        "metrics": {
            "frame_latency_p50_ms": H.percentile(lat, 50) * 1e3,
            "frame_latency_p95_ms": H.percentile(lat, 95) * 1e3,
        },
        "due": due.tolist(),
        "done_at": done_at,
        "events": events,
        "published": published,
        "records": records,
        "poses": poses,
        "final": final,
        "spans": ctx.spans,
        "trace": trace,
    }


def judge(ctx: H.Context, rec: Dict, storage=torch.float32) -> Dict[str, float]:
    """Replays the window's events on the reference and returns the numbers
    compared: the largest mismatch share over every publish, and over the
    final map's fields."""
    p = Params(ctx.config["map_config"])
    w = U.Weights.from_arrays(H.weight_arrays(ctx.config), ctx.device)
    alpha = float(ctx.config["extras"]["position_lowpass_alpha"])
    rep = R.ServiceReplay(p, w, alpha, ctx.device, storage)
    frames = [(rec["records"][k], rec["poses"][k][0], rec["poses"][k][1]) for k in range(len(rec["poses"]))]
    poses = [(pos, R_) for R_, _, pos in rec["poses"]]
    shares = rep.run(rec["events"], frames, poses, rec["published"], ctx.traffic["publish"]["layers"])
    fin = rec["final"]
    final = R.state_mismatch(fin["layers"], fin["normal"], fin["scalars"], rep.st, 0)
    return {
        "publish_mismatch": max(shares) if shares else 1.0,
        "final_mismatch": max(final.values()),
    }
