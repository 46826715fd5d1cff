"""The readings that the limits of ``correct`` are set from, and the faults
that have to fail them.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 30 [--faults]

runs the cell's window once per seed, in one process, on the card, and
judges each window twice: against the reference as the configuration
states it (float32: the lower reading, what sound runs give) and against
the control, the same reference holding its map in bfloat16 between steps
(the upper reading: the nearest lower precision, which has to fail). With
``--faults`` it also runs the window with the program broken underneath,
once per fault in ``FAULTS``, and judges it as a run does. Every reading is
printed as one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness as H  # noqa: E402

H.setup_environment()

import torch  # noqa: E402

from benchmark import run as RUN  # noqa: E402

# where the program is broken: what ``core.update_batch_aux`` returns for
# the maps of one update (every driver module's path goes through it)
FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def fault(kind: str):
    """The program's update broken underneath: ``unchanged`` returns the
    state it was given; ``half`` leaves out half of the batch (with one map,
    half of its points); ``altered`` moves the first map's heights by 1 mm
    in every update."""
    from elevation_mapping_cupy_torch import core

    real = core.update_batch_aux

    def broken(state, points, pad_mask, *args, **kw):
        if kind == "unchanged":
            ones = torch.ones(state.layers.shape[0], device=state.layers.device)
            return state, {"gate_survivor_frac": ones}
        b = state.layers.shape[0]
        if kind == "half" and b == 1:
            keep = pad_mask.clone()
            keep[:, pad_mask.shape[1] // 2:] = False
            return real(state, points, keep, *args, **kw)
        out, aux = real(state, points, pad_mask, *args, **kw)
        if kind == "half":
            h = b // 2
            out = out._replace(**{f: torch.cat([getattr(out, f)[:h], getattr(state, f)[h:]])
                                  for f in ("layers", "normal", "mean_error", "additive_mean_error")})
        elif kind == "altered":
            layers = out.layers.clone()
            layers[0, 0] += 1e-3
            out = out._replace(layers=layers)
        return out, aux

    core.update_batch_aux = broken
    try:
        yield
    finally:
        core.update_batch_aux = real


def readings(name: str, seed: int, seconds: float, device: str, config=None, traffic=None, faults=()):
    """One window of the cell: the numbers against the reference and
    against the control; then, per fault, a broken window's judgement."""
    man = H.manifest()
    ctx = RUN.context(name, seed, seconds, False, device, time.perf_counter(), man, config, traffic)
    driver = H.load_driver(ctx.traffic["driver"])
    rec = driver.run(ctx)
    gc.collect()
    out = {"seed": seed, "reference": driver.judge(ctx, rec),
           "control_bf16": driver.judge(ctx, rec, storage=torch.bfloat16)}
    del rec
    for kind in faults:
        ctx = RUN.context(name, seed, seconds, False, device, time.perf_counter(), man, config, traffic)
        with fault(kind):
            correct, rec, _, checks, _ = RUN.execute(ctx, man)
        out[f"fault_{kind}"] = {"correct": correct, "checks": checks}
        del rec
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        res = readings(args.workload, seed, args.seconds, "cuda", faults=FAULTS if args.faults else ())
        print(json.dumps({"workload": args.workload, **res}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
