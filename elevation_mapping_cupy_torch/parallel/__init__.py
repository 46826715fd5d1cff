"""Batched, env-sharded stepping of many maps (the JAX package's
``parallel/``): env batching, meshes of processes, the multi-process
runtime and checkpoints. Spatial sharding of one map is not ported yet."""

from .mesh import make_mesh  # noqa: F401
from .batch import init_batch, batched_update, batched_move_to, batched_input_image, shard_states, batch_stats  # noqa: F401
from . import distributed  # noqa: F401
from . import checkpoint  # noqa: F401
