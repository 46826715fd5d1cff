"""Driver ``batched_steps``: batched datagen, a closed loop of steps issued
back to back.

Set-up makes a pool of episodes on the device from the seed (every map its
own terrain, its sensor's cloud at each step) and warms every shape with one
episode on a throwaway batch. In the window each step is
``parallel.batched_move_to`` to the robots' positions followed by
``parallel.batched_update`` with the step's clouds, with no synchronise
between steps, as a datagen loop streams them; at each episode's start the
maps are fresh ones (``parallel.init_batch``) and the next episode of the
pool, cycled, feeds them. The window closes with a synchronise.

The reference replays two episodes that the window completed, the last one
and one drawn from the seed, from fresh maps, and every field of every map
at their ends is held to it.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import harness as H
from benchmark.reference import replay as R
from benchmark.reference import update as U
from benchmark.reference.params import Params
from benchmark.traffic import terrain_clouds


def _final(st) -> Dict:
    return {"layers": st.layers, "normal": st.normal,
            "scalars": torch.cat([st.center, st.mean_error[:, None], st.additive_mean_error[:, None]], dim=1)}


def run(ctx: H.Context) -> Dict:
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.parallel import batched_move_to, batched_update, init_batch

    tr = ctx.traffic
    cfg = MapConfig(**H.map_config_fields(ctx.config))
    weights = TravFilter(**H.weight_arrays(ctx.config)).to(ctx.device)
    b, n, steps = tr["maps"], tr["points"], tr["episode_steps"]
    t_in = time.perf_counter()
    pool = terrain_clouds.make_pool(ctx.seed, tr, cfg.cell_n, cfg.resolution, ctx.device)
    t_warm = time.perf_counter()
    dev = ctx.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3).contiguous()
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((b,), device=dev)
    sampled = ctx.seed % 2   # the episode compared besides the last one

    def step(states, i):
        ep = pool[(i // steps) % len(pool)]
        s = i % steps
        if s == 0:
            states = init_batch(cfg, b, dev)
        states = batched_move_to(states, ep.base[s], eye, cfg)
        return batched_update(states, ep.clouds[s], mask, eye, ep.sensor[s], zero, zero, weights, cfg)

    warm = None
    for i in range(steps):
        warm = step(warm, i)
    del warm
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx.say(f"set-up: imports and CUDA {t_in - ctx.process_start:.3f} s, pool {t_warm - t_in:.3f} s, "
            f"warm-up {time.perf_counter() - t_warm:.3f} s")
    tracer = H.Tracer(ctx.spans)
    if ctx.trace and dev != "cpu":
        H.Tracer.warm()
    # the traced part is the window's last seconds: the profiler's stop,
    # which holds the interpreter for seconds, comes after the last step
    trace_lo = ctx.seconds - min(5.0, ctx.seconds / 3)
    trace = None
    kept: Dict[int, object] = {}
    states = None
    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= ctx.seconds and i >= steps:
            break
        if ctx.trace and trace is None and tracer.prof is None and now >= trace_lo:
            tracer.start()
        with ctx.spans.span("batched.step", index=i):
            states = step(states, i)
        i += 1
        if i % steps == 0:
            e = i // steps - 1
            kept = {k: v for k, v in kept.items() if k == sampled}
            kept[e] = states
    if tracer.prof is not None:
        trace = tracer.stop()
    if dev != "cpu":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    episodes = i // steps
    judged = sorted({min(sampled, episodes - 1), episodes - 1})
    finals = {e: {k: v.detach().clone() for k, v in _final(kept[e]).items()} for e in judged}
    del states, kept
    return {
        "window_start": t0,
        "window_end": t1,
        "attempted": i * b,
        "failed": 0,
        "steps": i,
        "maps": b,
        "metrics": {"maps_per_s": i * b / (t1 - t0)},
        "pool": pool,
        "finals": finals,
        "spans": ctx.spans,
        "trace": trace,
    }


def judge(ctx: H.Context, rec: Dict, storage=torch.float32) -> Dict[str, float]:
    """Replays the compared episodes on the reference and returns the
    largest mismatch share over every field of every map at their ends."""
    p = Params(ctx.config["map_config"])
    w = U.Weights.from_arrays(H.weight_arrays(ctx.config), ctx.device)
    worst = 0.0
    for e, fin in rec["finals"].items():
        ep = rec["pool"][e % len(rec["pool"])]
        st = R.replay_episode(p, w, ep.clouds, ep.base, ep.sensor, storage)
        for m in range(rec["maps"]):
            share = R.state_mismatch(fin["layers"][m], fin["normal"][m], fin["scalars"][m], st, m)
            worst = max(worst, max(share.values()))
        del st
    return {"final_mismatch": worst}
