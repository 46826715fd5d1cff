"""Convert reference traversability-filter weights (pickle) to .npz.

The reference ships trained CNN weights as a pickle of torch-layout arrays
(config/core/weights.dat, loaded by parameter.py:228-240). For output parity
the engine needs the same trained weights; this one-shot tool re-encodes
them as a plain .npz (keys w1, w2, w3, w_out) with no pickle dependency.

Usage:
    python -m elevation_mapping_cupy_torch.utils.convert_weights \
        <weights.dat> <out.npz>
"""

from __future__ import annotations

import pickle
import sys

import numpy as np


def convert(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        w = pickle.load(f)
    np.savez(
        dst,
        w1=np.asarray(w["conv1.weight"], np.float32),
        w2=np.asarray(w["conv2.weight"], np.float32),
        w3=np.asarray(w["conv3.weight"], np.float32),
        w_out=np.asarray(w["conv_final.weight"], np.float32),
    )
    print(f"wrote {dst}")


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2])
