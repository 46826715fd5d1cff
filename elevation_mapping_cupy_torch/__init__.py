"""PyTorch/CUDA port of the elevation mapping engine, for NVIDIA Hopper.

The same robot-centric 2.5D grid map as ``elevation_mapping_cupy_tpu`` (the
JAX reference, which this package never imports), in PyTorch, with the
JAX package's TPU kernels rewritten as CUDA kernels for ``sm_90a``
(``csrc/``, built with nvcc at first use on the card). It runs on a CUDA
device unless the caller asks for the CPU.
"""

from .config import MapConfig, load_config, load_config_with_extras
from .state import MapState, init_state

__all__ = ["MapConfig", "load_config", "load_config_with_extras", "MapState", "init_state"]
