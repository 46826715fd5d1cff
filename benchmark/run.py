"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The cell's
configuration, traffic mix and driver are found by the names that
``BENCHMARK.json`` gives them (see ``benchmark/README.md``). A run makes its
inputs from the seed, builds and warms the program, measures for
``--seconds``, then replays what the window fed the program on the plain
reference (``benchmark/reference/``) and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last the
numbers compared with their limits under ``checks``. Without a card, or
with JAX or the JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness as H  # noqa: E402

H.setup_environment()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(name: str, seed: int, seconds: float, trace: bool, device: str, process_start: float,
            man=None, config=None, traffic=None) -> H.Context:
    """The cell's files and the run's arguments; ``config`` and ``traffic``
    replace the files' contents (tests run cells at small sizes)."""
    man = man or H.manifest()
    cell = H.workload(man, name)
    return H.Context(
        cell=cell,
        config=config if config is not None else H.config_file(man, cell["config"]),
        traffic=traffic if traffic is not None else H.traffic_file(cell["traffic"]),
        seed=seed, seconds=seconds, trace=trace, device=device, process_start=process_start, spans=H.Spans(),
    )


def execute(ctx: H.Context, man=None, peak_fn=None):
    """Runs the cell: its driver module's window, the reference's judgement, the
    metrics. Returns (correct, the driver module's record, metrics, checks, peak
    device memory read before the reference ran)."""
    man = man or H.manifest()
    driver = H.load_driver(ctx.traffic["driver"])
    rec = driver.run(ctx)
    setup_s = rec["window_start"] - ctx.process_start
    peak = peak_fn() if peak_fn else 0
    gc.collect()
    if ctx.device != "cpu":
        import torch

        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = driver.judge(ctx, rec)
    ctx.say(f"set-up {setup_s:.3f} s, window {rec['window_end'] - rec['window_start']:.3f} s, "
            f"reference {time.perf_counter() - t_judge:.3f} s")
    limits = ctx.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(H.finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    e2e, layer = H.cell_metrics(man, ctx.cell["name"])
    values = dict(rec["metrics"], setup_s=setup_s)
    metrics = {}
    if not ctx.trace:
        for m in e2e:
            metrics[m["name"]] = (values[m["name"]], m["unit"])
    else:
        for m in layer:
            v = H.load_metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    return correct, rec, metrics, checks, peak


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    man = H.manifest()
    cell = H.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", PROCESS_START, man)
    correct, rec, metrics, checks, peak = execute(ctx, man, peak_fn=torch.cuda.max_memory_allocated)
    found = H.forbidden_loaded()
    if found:
        print(f"benchmark: {', '.join(found)} loaded in the measuring process", file=sys.stderr)
        return 3
    device = H.device_info(peak)
    bd = None
    if ctx.trace:
        tr = rec["trace"]
        if tr is None or not tr["device"]:
            print("benchmark: the traced window holds no device operation", file=sys.stderr)
            return 4
        lo, hi = tr["window"]
        device["busy_s"] = H.union_seconds([(a, b) for _, a, b in tr["device"]], lo, hi)
        device["window_s"] = hi - lo
        bd = H.breakdown(tr, lo, hi)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(H.result_line(correct, rec["attempted"], rec["failed"], metrics, device, checks, bd), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
