"""Probability/class-id bit packing (reference: semantic_sensor/utils.py:9-28).

A float16 probability and a uint16 class id packed into one float32's bits —
the MEM class_max wire format.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_max", "decode_max"]


def encode_max(prob: np.ndarray, cls: np.ndarray) -> np.ndarray:
    lo = prob.astype(np.float16).view(np.uint16).astype(np.uint32)
    bits = (cls.astype(np.uint32) << 16) | lo
    return bits.view(np.float32)


def decode_max(packed: np.ndarray):
    bits = packed.astype(np.float32).view(np.uint32)
    prob = (bits & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    return prob, (bits >> 16)
