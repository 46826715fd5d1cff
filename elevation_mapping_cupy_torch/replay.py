"""Replay a recorded log through the PyTorch port and diff it against a
reference layer dump, in one command:

    python -m elevation_mapping_cupy_torch.replay \\
        --log run.npz --config configs/core_param.yaml \\
        --diff-against reference_layers.npz --layers elevation,traversability

The port's counterpart of ``python -m elevation_mapping_cupy_tpu.replay``
(same arguments, schemas, JSON report and exit codes), plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).

* ``--log`` - the engine log schema (``runtime/replay.py::LogWriter``): an
  .npz with ``n_frames``, ``channels`` and per-frame ``f{i}_points`` (N, C)
  f32, ``f{i}_R`` (3,3), ``f{i}_t`` (3,), ``f{i}_position`` (3,),
  ``f{i}_stamp``.
* ``--diff-against`` - an .npz of per-frame reference layers with keys
  ``f{i}_<layer>`` of shape (cell_n-2, cell_n-2), the schema ``--out``
  writes, so a replay by either package diffs directly.
* ``--config`` - a reference-style YAML (needs PyYAML); without it the
  repository's ``configs/core_param.yaml`` when present, else the default
  ``MapConfig``.

Output: one JSON line per layer with per-frame max / p99 / mean-abs diffs
and validity IoU, then an overall ``parity_ok`` verdict against ``--atol``
(exit 0 when it holds, 1 when not). Replays default to
``raycast_mode="exact"``, the reference-parity march.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import MapConfig, load_config
from .runtime.replay import read_log, replay

__all__ = ["diff_snapshots", "main"]


def _load_layer_dump(path: str, layers: Sequence[str]) -> List[Dict[str, np.ndarray]]:
    with np.load(path, allow_pickle=True) as z:
        n = int(z["n_frames"]) if "n_frames" in z else None
        if n is None:  # count frames from keys
            n = 0
            while any(f"f{n}_{l}" in z for l in layers):
                n += 1
        return [{l: z[f"f{i}_{l}"] for l in layers if f"f{i}_{l}" in z} for i in range(n)]


def diff_snapshots(
    got: List[Dict[str, np.ndarray]],
    ref: List[Dict[str, np.ndarray]],
    layers: Sequence[str],
    atol: float,
) -> Dict:
    """Per-layer, per-frame diff stats on jointly-finite cells."""
    n = min(len(got), len(ref))
    report: Dict = {"n_frames": n, "layers": {}, "parity_ok": True}
    for layer in layers:
        per_frame = []
        for i in range(n):
            if layer not in got[i] or layer not in ref[i]:
                continue
            a, b = got[i][layer], ref[i][layer]
            fa, fb = np.isfinite(a), np.isfinite(b)
            both = fa & fb
            iou = float(both.sum() / max((fa | fb).sum(), 1))
            d = np.abs(a[both] - b[both]) if both.any() else np.zeros(1)
            per_frame.append({
                "frame": i,
                "max": float(d.max()),
                "p99": float(np.quantile(d, 0.99)),
                "mean": float(d.mean()),
                "finite_iou": round(iou, 4),
            })
        worst = max((f["max"] for f in per_frame), default=0.0)
        ok = worst <= atol
        report["layers"][layer] = {
            "worst_max": worst,
            "worst_p99": max((f["p99"] for f in per_frame), default=0.0),
            "min_finite_iou": min((f["finite_iou"] for f in per_frame), default=1.0),
            "ok": ok,
            "per_frame": per_frame,
        }
        report["parity_ok"] = report["parity_ok"] and ok
    return report


def _save_snapshots(path: str, snaps: List[Dict[str, np.ndarray]]) -> None:
    arrays = {"n_frames": np.int64(len(snaps))}
    for i, s in enumerate(snaps):
        for k, v in s.items():
            arrays[f"f{i}_{k}"] = v
    np.savez_compressed(path, **arrays)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m elevation_mapping_cupy_torch.replay",
        description="Replay a recorded log through the PyTorch port and diff "
                    "against a reference layer dump (parity harness).",
    )
    ap.add_argument("--log", help="engine log .npz (LogWriter schema)")
    ap.add_argument("--from-pointcloud2",
                    help="RAW PointCloud2 dump .npz to convert first (not ported yet)")
    ap.add_argument("--config", default=None,
                    help="YAML config (default: configs/core_param.yaml); needs PyYAML")
    ap.add_argument("--layers", default="elevation,traversability,is_valid")
    ap.add_argument("--raycast-mode", default="exact", choices=["exact", "polar", "auto"])
    ap.add_argument("--diff-against", default=None,
                    help=".npz of reference per-frame layers (f{i}_<layer>)")
    ap.add_argument("--out", default=None, help="write this replay's per-frame layers to .npz")
    ap.add_argument("--atol", type=float, default=2e-4,
                    help="parity tolerance on jointly-finite cells")
    ap.add_argument("--summary-only", action="store_true",
                    help="omit per-frame rows from the diff JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the map (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.from_pointcloud2:
        ap.error("--from-pointcloud2 needs the runtime service's SensorFrame and its native "
                 "deinterleaver, which come with the runtime slice of the port (ROADMAP.md "
                 "§A); convert the dump with the JAX package's replay CLI "
                 "(--from-pointcloud2 ... --save-log) and pass the log with --log")
    if not args.log:
        ap.error("--log is required")

    cfg_path = args.config or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "core_param.yaml"
    )
    if os.path.exists(cfg_path):
        try:
            import yaml  # noqa: F401
        except ImportError:
            ap.error(f"reading the config {cfg_path} needs PyYAML, which is not installed")
        cfg = load_config(cfg_path)
    elif args.config:
        ap.error(f"--config {args.config}: no such file")
    else:
        cfg = MapConfig()
    # size the padded point bucket to the log's largest cloud
    biggest = max((f["points"].shape[0] for f in read_log(args.log)), default=0)
    if biggest > cfg.max_points:
        cfg = dataclasses.replace(cfg, max_points=biggest)
    layers = [l for l in args.layers.split(",") if l]
    snaps = replay(args.log, cfg, snapshot_layers=layers, raycast_mode=args.raycast_mode, device=args.device)

    if args.out:
        _save_snapshots(args.out, snaps)
        print(json.dumps({"out": args.out, "n_frames": len(snaps), "layers": layers}))
    if args.diff_against:
        ref = _load_layer_dump(args.diff_against, layers)
        report = diff_snapshots(snaps, ref, layers, args.atol)
        if args.summary_only:
            for l in report["layers"].values():
                l.pop("per_frame", None)
        print(json.dumps(report))
        return 0 if report["parity_ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
