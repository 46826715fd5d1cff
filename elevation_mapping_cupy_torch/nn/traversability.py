"""Learned traversability filter: 3 dilated 3x3 convs + 1x1 head.

PyTorch counterpart of ``elevation_mapping_cupy_tpu/nn/traversability.py``
(reference: traversability_filter.py:12-47): conv(3x3, dilation 1/2/3) ->
center-crop to a common (H-6, W-6) frame -> concat 12ch -> |.| -> 1x1 conv
-> exp(-x).

The JAX package runs the convolutions at ``Precision.HIGHEST``; cuDNN takes
float32 convolutions through TF32 by default, so ``forward`` turns TF32 off
for its convolutions. JAX's OIHW weight layout is PyTorch's, so the weights
are used as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TravFilter", "default_weights", "load_weights_npz", "DEFAULT_WEIGHT_FILE"]

DEFAULT_WEIGHT_FILE = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "data", "traversability_weights.npz"
)


class TravFilter(nn.Module):
    """Frozen CNN; ``forward`` maps an (H, W) dilated upper-bound layer to
    (H-6, W-6) traversability."""

    def __init__(self, w1, w2, w3, w_out):
        super().__init__()
        for name, w, shape in (
            ("w1", w1, (4, 1, 3, 3)),
            ("w2", w2, (4, 1, 3, 3)),
            ("w3", w3, (4, 1, 3, 3)),
            ("w_out", w_out, (1, 12, 1, 1)),
        ):
            t = w if torch.is_tensor(w) else torch.from_numpy(np.asarray(w, np.float32))
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
            self.register_buffer(name, t.to(torch.float32).contiguous())

    def forward(self, elevation: torch.Tensor) -> torch.Tensor:
        x = elevation[None, None]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            o1 = F.conv2d(x, self.w1, dilation=1)[:, :, 2:-2, 2:-2]
            o2 = F.conv2d(x, self.w2, dilation=2)[:, :, 1:-1, 1:-1]
            o3 = F.conv2d(x, self.w3, dilation=3)
            cat = torch.abs(torch.cat([o1, o2, o3], dim=1))
            out = F.conv2d(cat, self.w_out)
        return torch.exp(-out)[0, 0]


def default_weights() -> TravFilter:
    """All-zero weights (traversability 1 everywhere)."""
    z = np.zeros((4, 1, 3, 3), np.float32)
    return TravFilter(z, z, z, np.zeros((1, 12, 1, 1), np.float32))


def load_weights_npz(path: str) -> TravFilter:
    """Load converted weights (the npz of ``data/traversability_weights.npz``)."""
    with np.load(path) as z:
        return TravFilter(z["w1"], z["w2"], z["w3"], z["w_out"])
