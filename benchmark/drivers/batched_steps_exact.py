"""Driver ``batched_steps_exact``: the driver ``batched_steps`` on a
configuration whose maps are cleaned up by the exact march, and a probe of
that cleanup after the window.

The window is ``batched_steps``' own: a closed loop of batched steps, each
``parallel.batched_move_to`` and ``parallel.batched_update``. While the
window is traced, the shapes of K2's launches are recorded as well (for
``k2_roofline``). In that traffic the cleanup changes almost no cell:
nearly every cell a ray crosses took points in the same update, so it is
neither invalid nor past the recency gate (time >= 0.5), and the march
culls.

So after the window, untimed, each compared episode is replayed from fresh
maps through the program once more, and its maps then age by the node's
time timer (``PROBE_TICKS`` calls of ``core.update_time``) and take one
more update, the probe: the last step's cloud ``PROBE_DROP_M`` lower, from
the same pose, as when ground the maps hold has gone. Every ray then passes
under held cells, and the exact cleanup lowers their validity, raises their
variance and writes their upper bounds.

The compared episodes and their probes are replayed on the dense exact
march of ``reference/exact.py`` instead of the polar cleanup.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import exact_march as K2
from benchmark import harness as H
from benchmark.reference import exact as E
from benchmark.reference import replay as R
from benchmark.reference import update as U
from benchmark.reference.params import Params

_base = H.load_driver("batched_steps")

# the node's time-timer ticks that age every cell past the recency gate
# (0.6 s of time_interval 0.1: six sums of 0.1 in float32 stay above 0.5)
PROBE_TICKS = 6
# how far below the ground the maps hold the probe's cloud lies
PROBE_DROP_M = 0.5


def probe_cloud(ep) -> torch.Tensor:
    """The probe's cloud: the episode's last cloud, ``PROBE_DROP_M`` lower."""
    cloud = ep.clouds[-1].clone()
    cloud[..., 2] -= PROBE_DROP_M
    return cloud


def _probe(ctx: H.Context, rec: Dict) -> Dict[int, Dict]:
    """The program's maps after each compared episode's probe."""
    from elevation_mapping_cupy_torch import MapConfig, core
    from elevation_mapping_cupy_torch.nn.traversability import TravFilter
    from elevation_mapping_cupy_torch.parallel import batched_move_to, batched_update, init_batch

    cfg = MapConfig(**H.map_config_fields(ctx.config))
    weights = TravFilter(**H.weight_arrays(ctx.config)).to(ctx.device)
    b, dev = rec["maps"], ctx.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3).contiguous()
    zero = torch.zeros((b,), device=dev)
    out = {}
    for e in rec["finals"]:
        ep = rec["pool"][e % len(rec["pool"])]
        mask = torch.ones(ep.clouds[0].shape[:2], dtype=torch.bool, device=dev)
        states = init_batch(cfg, b, dev)
        for cloud, base, sensor in zip(ep.clouds, ep.base, ep.sensor):
            states = batched_move_to(states, base, eye, cfg)
            states = batched_update(states, cloud, mask, eye, sensor, zero, zero, weights, cfg)
        for _ in range(PROBE_TICKS):
            states = core.update_time(states, cfg)
        states = batched_update(states, probe_cloud(ep), mask, eye, ep.sensor[-1], zero, zero, weights, cfg)
        out[e] = {k: v.detach().clone() for k, v in _base._final(states).items()}
    return out


def run(ctx: H.Context) -> Dict:
    launches = []
    with K2.recording(ctx.spans, launches):
        rec = _base.run(ctx)
    rec["k2"] = launches
    rec["probes"] = _probe(ctx, rec)
    return rec


def _worst(fin: Dict, st: U.State, maps: int) -> float:
    worst = 0.0
    for m in range(maps):
        share = R.state_mismatch(fin["layers"][m], fin["normal"][m], fin["scalars"][m], st, m)
        worst = max(worst, max(share.values()))
    return worst


def judge(ctx: H.Context, rec: Dict, storage=torch.float32) -> Dict[str, float]:
    """Replays the compared episodes and their probes on the exact reference
    and returns the largest mismatch share over every field of every map at
    the episodes' ends and after their probes."""
    ends, probes = mismatches(ctx, rec, storage)
    ctx.say(f"final_mismatch: episode ends {ends}, probes {probes}")
    return {"final_mismatch": max(ends, probes)}


def mismatches(ctx: H.Context, rec: Dict, storage=torch.float32):
    """(at the episodes' ends, after their probes): each the largest
    mismatch share over every field of every map."""
    p = Params(ctx.config["map_config"])
    w = U.Weights.from_arrays(H.weight_arrays(ctx.config), ctx.device)
    ends = probes = 0.0
    for e, fin in rec["finals"].items():
        ep = rec["pool"][e % len(rec["pool"])]
        st = E.replay_episode(p, w, ep.clouds, ep.base, ep.sensor, storage)
        ends = max(ends, _worst(fin, st, rec["maps"]))
        for _ in range(PROBE_TICKS):
            st = U.update_time(st, p, storage)
        b, n = ep.clouds[-1].shape[:2]
        dev = ep.clouds[-1].device
        eye = torch.eye(3, device=dev).expand(b, 3, 3)
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
        zero = torch.zeros((b,), device=dev)
        st = E.update(st, probe_cloud(ep), mask, eye, ep.sensor[-1], zero, zero, w, p, storage)
        probes = max(probes, _worst(rec["probes"][e], st, rec["maps"]))
        del st
    return ends, probes
