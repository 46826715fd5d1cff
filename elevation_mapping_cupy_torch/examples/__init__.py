"""The repository's shipped examples (``examples/*.py``) on the PyTorch port.

One module per JAX example, of the same name:

    python -m elevation_mapping_cupy_torch.examples.<name> [--device cpu]

Each module has a ``run(device=..., **sizes)`` that returns the numbers and
arrays the example prints, and a ``main(argv=None)`` that prints the lines
its JAX twin prints. The examples run on the card unless the caller asks
for the CPU (``--device cpu``, ``run(device="cpu")``).
"""

from __future__ import annotations

import argparse
from typing import Union

import torch

from ..mapper import resolve_device

__all__ = ["EXAMPLES", "resolve", "add_device_argument", "sync"]

EXAMPLES = (
    "plane_decomposition_demo",
    "minimal_mapping",
    "semantic_mapping",
    "batched_datagen",
    "robot_stack",
    "large_world_sharded",
)


def resolve(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means CUDA; without a card that raises and names ``--device
    cpu``. Nothing falls back to the CPU unless the caller asks for it."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise RuntimeError(
            "this example runs on a CUDA device and none is available; "
            "pass --device cpu (run(device='cpu')) to run it on the CPU"
        ) from e


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the kernels' plain versions)")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (host timings end here)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
