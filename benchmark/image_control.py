"""The readings that the limits of ``correct`` of a cell driven by
``batched_steps_image`` are set from, and the faults of its image path that
have to fail them.

    python3 benchmark/image_control.py --workload datagen_mem.b64_ep8_cam --seeds 1,2,3 --seconds 30 [--faults]

runs the cell's window once per seed, in one process, on the card, and
judges it against the reference and against the control
(``control.readings``: the reference holding its map, and here its
semantic layers too, in bfloat16 between steps). With ``--faults`` it also
runs the window once per fault in the driver's ``FAULTS``, with the
program's image path broken underneath (the driver's ``fault``), and judges
it as a run does. Every reading is printed as one JSON line. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness as H  # noqa: E402

H.setup_environment()

import torch  # noqa: E402

from benchmark import control as C  # noqa: E402
from benchmark import run as RUN  # noqa: E402


def readings(name: str, seed: int, seconds: float, device: str, config=None, traffic=None, faults=()):
    """``control.readings`` of one window, then, per fault of the image
    path, a broken window's judgement."""
    out = C.readings(name, seed, seconds, device, config, traffic)
    man = H.manifest()
    for kind in faults:
        ctx = RUN.context(name, seed, seconds, False, device, time.perf_counter(), man, config, traffic)
        with H.load_driver(ctx.traffic["driver"]).fault(kind):
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
        print("image_control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = H.manifest()
    driver = H.load_driver(H.traffic_file(H.workload(man, args.workload)["traffic"])["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        res = readings(args.workload, seed, args.seconds, "cuda", faults=driver.FAULTS if args.faults else ())
        print(json.dumps({"workload": args.workload, **res}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
