"""Driver ``batched_steps_image``: batched multi-modal datagen, the closed
loop of ``batched_steps`` with one camera image a map a step.

Set-up makes ``batched_steps``' pool of episodes (every map its own terrain,
its depth sensor's cloud at each step) and, for each episode, every map's
camera images (``traffic/camera_images.py``), all on the device, and warms
every shape with one episode on a throwaway batch. In the window each step
is ``parallel.batched_move_to`` to the robots' positions,
``parallel.batched_update`` with the step's clouds, then
``parallel.batched_input_image`` with the step's images, issued back to back
with no synchronise; at each episode's start the maps are fresh ones. The
window closes with a synchronise.

The reference replays two episodes that the window completed, the last one
and one drawn from the seed, from fresh maps on ``reference/update.py`` and
``reference/image.py``: ``final_mismatch`` holds every field of every map
at their ends to it, the semantic layers included, and
``semantic_mismatch`` is the share of the semantic layers' cells that
disagree.

``FAULTS`` break the program's image path underneath a run (``fault``);
``benchmark/image_control.py`` reads them.
"""

from __future__ import annotations

import builtins
import contextlib
import time
from typing import Dict

import torch

from benchmark import harness as H
from benchmark.reference import image as I
from benchmark.reference import replay as R
from benchmark.reference import update as U
from benchmark.reference.params import Params
from benchmark.traffic import camera_images, terrain_clouds

_base = H.load_driver("batched_steps")

# the faults the checks have to catch: every candidate cell seen (no
# occlusion), the walk cut after WALK_CUT steps, each map fused with the next
# map's camera, the planes of grass and tree swapped
FAULTS = ("occlusion_off", "walk_cut", "next_camera", "planes_swapped")
WALK_CUT = 8


def run(ctx: H.Context) -> Dict:
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.parallel import (batched_input_image, batched_move_to, batched_update,
                                                       init_batch)

    tr = ctx.traffic
    cfg = MapConfig(**H.map_config_fields(ctx.config))
    weights = TravFilter(**H.weight_arrays(ctx.config)).to(ctx.device)
    b, n, steps = tr["maps"], tr["points"], tr["episode_steps"]
    channels = tuple(tr["channels"])
    t_in = time.perf_counter()
    pool = terrain_clouds.make_pool(ctx.seed, tr, cfg.cell_n, cfg.resolution, ctx.device)
    cams = camera_images.make_pool(ctx.seed, tr, pool, ctx.device)
    t_warm = time.perf_counter()
    dev = ctx.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3).contiguous()
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((b,), device=dev)
    sampled = ctx.seed % 2   # the episode compared besides the last one

    def step(states, i):
        e, s = (i // steps) % len(pool), i % steps
        ep, cam = pool[e], cams[e]
        if s == 0:
            states = init_batch(cfg, b, dev)
        states = batched_move_to(states, ep.base[s], eye, cfg)
        states = batched_update(states, ep.clouds[s], mask, eye, ep.sensor[s], zero, zero, weights, cfg)
        return batched_input_image(states, cam.images[s], cam.R[s], cam.t[s], cam.K, cam.D, cfg, channels)

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
            kept = {k: v for k, v in kept.items() if k == sampled}
            kept[i // steps - 1] = states
    if tracer.prof is not None:
        trace = tracer.stop()
    if dev != "cpu":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    episodes = i // steps
    judged = sorted({min(sampled, episodes - 1), episodes - 1})
    finals = {e: {k: v.detach().clone() for k, v in dict(_base._final(kept[e]), semantic=kept[e].semantic).items()}
              for e in judged}
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
        "cameras": cams,
        "finals": finals,
        "spans": ctx.spans,
        "trace": trace,
    }


def judge(ctx: H.Context, rec: Dict, storage=torch.float32) -> Dict[str, float]:
    """Replays the compared episodes on the reference and returns the
    largest mismatch share over every field of every map at their ends
    (each semantic layer a field), and the share of all the semantic
    layers' cells that disagree."""
    p = Params(ctx.config["map_config"])
    w = U.Weights.from_arrays(H.weight_arrays(ctx.config), ctx.device)
    channels = tuple(ctx.traffic["channels"])
    worst = semantic = 0.0
    for e, fin in rec["finals"].items():
        ep, cam = rec["pool"][e % len(rec["pool"])], rec["cameras"][e % len(rec["pool"])]
        st, sem = I.replay_episode(p, w, ep.clouds, ep.base, ep.sensor, cam.images, cam.R, cam.t, cam.K, cam.D,
                                   channels, storage)
        for m in range(rec["maps"]):
            share = R.state_mismatch(fin["layers"][m], fin["normal"][m], fin["scalars"][m], st, m)
            worst = max(worst, max(share.values()))
        layers, overall = I.semantic_mismatch(fin["semantic"], sem, p)
        worst = max(worst, max(layers.values()))
        semantic = max(semantic, overall)
        del st, sem
    return {"final_mismatch": worst, "semantic_mismatch": semantic}


@contextlib.contextmanager
def fault(kind: str):
    """The program's image path broken underneath, one of ``FAULTS``:
    ``occlusion_off`` finds no cell occluded; ``walk_cut`` stops the
    Bresenham walk after ``WALK_CUT`` steps; ``next_camera`` fuses into each
    map the next map's camera (its image and its pose: every robot of a
    step stands at the same pose, so the images tell them apart);
    ``planes_swapped`` swaps the image planes of grass and tree."""
    from elevation_mapping_cupy_torch import core
    from elevation_mapping_cupy_torch.ops import image as img_ops

    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    real_input, real_walk = core.input_image, img_ops._occlusion_bresenham

    def broken_input(state, image, R, t, K, D, cfg, channels):
        if kind == "next_camera":
            image, R, t, K, D = (x.roll(-1, 0) for x in (image, R, t, K, D))
        elif kind == "planes_swapped":
            g, tr_ = (camera_images.planes(channels[:channels.index(ch)]) for ch in ("grass", "tree"))
            order = list(range(image.shape[1]))
            order[g], order[tr_] = order[tr_], order[g]
            image = image[:, order]
        return real_input(state, image, R, t, K, D, cfg, channels)

    def no_walk(flat_h, flat_valid, candidate, *args):
        return torch.zeros_like(candidate)

    def first_steps(*args):
        return builtins.range(*args)[:WALK_CUT]

    if kind == "occlusion_off":
        img_ops._occlusion_bresenham = no_walk
    elif kind == "walk_cut":
        img_ops.range = first_steps
    else:
        core.input_image = broken_input
    try:
        yield
    finally:
        core.input_image, img_ops._occlusion_bresenham = real_input, real_walk
        if kind == "walk_cut":
            del img_ops.range
