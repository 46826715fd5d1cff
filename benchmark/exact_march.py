"""The exact march's kernel K2 in a traced window: the shapes of its
launches, recorded by wrapping its entry point as the harness wraps K1's,
the bytes each launch has to move, and its share of its memory roofline.

The wrapper records while the benchmark's spans are tracing. It takes the
entry point's arguments as the program hands them, one map or a batch, so
it reads a program that launches K2 once a map as well as one that launches
it once a step, and one that hands K2 the map's layers for the whole
cleanup (``exact_cleanup``) as well as one that hands it the pack.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from benchmark import harness as H

__all__ = ["K2_KERNELS", "k2_bytes", "recording", "k2_roofline"]

# the device operations of one K2 launch: the outputs' initialisation and
# the march (``csrc/exact_march.cu``)
K2_KERNELS = ("init_outputs_kernel", "exact_march_kernel")


def k2_bytes(b: int, n: int, n2: int, gate_cells: int) -> int:
    """The bytes a K2 launch of ``b`` maps has to move, per map: each ray's
    end point (3 floats) and validity (1 byte) read once, the sensor
    position, the pack's 7 values per cell and the gate table (``gate_cells``
    floats) read once, the decrement, hit count and upper bound written once
    a cell, and with a gate the two int64 segment counts (the smoke test's
    count). A ray's direction and step count are computed, not read."""
    per_map = 4 * (3 * n + 3 + 7 * n2 + gate_cells + 3 * n2) + n + (16 if gate_cells else 0)
    return b * per_map


@contextlib.contextmanager
def recording(spans: H.Spans, into: List[Tuple[float, int, int, int, int]]):
    """Wraps the program's K2 entry point; while ``spans`` trace, each call
    appends (host time, maps, rays a map, cells a map, gate cells a map) to
    ``into``."""
    from elevation_mapping_cupy_torch.ops import cuda_march

    entry = cuda_march.exact_march
    # a program whose whole cleanup is one K2 call hands K2 the layers
    # instead of the pack, and K2 builds a table of ceil(n / block) gate
    # blocks a side
    cleanup = getattr(cuda_march, "exact_cleanup", None)

    def recorded(pack, world, valid, t, cfg, gate=None, block=None):
        if spans.tracing:
            b = pack.shape[0] if pack.dim() == 3 else 1
            gate_cells = 0 if gate is None else gate.table.numel() // b
            into.append((time.perf_counter(), b, int(world.shape[-2]), int(pack.shape[-2]), gate_cells))
        return entry(pack, world, valid, t, cfg, gate, block)

    def recorded_cleanup(layers, normal, inlier_cnt, world, valid, t, cfg, gate=None):
        if spans.tracing:
            n = cfg.cell_n
            gate_cells = 0 if gate is None else (-(-n // gate.block)) ** 2
            into.append((time.perf_counter(), int(layers.shape[0]), int(world.shape[-2]), n * n, gate_cells))
        return cleanup(layers, normal, inlier_cnt, world, valid, t, cfg, gate)

    cuda_march.exact_march = recorded
    if cleanup is not None:
        cuda_march.exact_cleanup = recorded_cleanup
    try:
        yield into
    finally:
        cuda_march.exact_march = entry
        if cleanup is not None:
            cuda_march.exact_cleanup = cleanup


def k2_roofline(trace: Optional[Dict], launches) -> Optional[float]:
    """K2's share of its memory roofline in the traced window, in %: the
    least time its launches' bytes take at the device's rate over the time
    its launches took on the device (each march with the initialisation
    issued just before it). Means per launch, so that a record the tracer
    drops does not skew it."""
    if not trace or not launches:
        return None
    dev = trace["device"]
    times = []
    for i, (name, a, b) in enumerate(dev):
        if K2_KERNELS[1] in name:
            init = dev[i - 1] if i > 0 and K2_KERNELS[0] in dev[i - 1][0] else None
            times.append((b - a) + ((init[2] - init[1]) if init else 0.0))
    lo, hi = trace["window"]
    bound = [k2_bytes(*shape) / H.HBM_BYTES_PER_S for t, *shape in launches if lo <= t <= hi]
    if not times or not bound:
        return None
    return 100.0 * (sum(bound) / len(bound)) / (sum(times) / len(times))
