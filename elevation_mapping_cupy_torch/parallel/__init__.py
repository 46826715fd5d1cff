"""Batched, env-sharded and spatially sharded stepping of maps (the JAX
package's ``parallel/``): env batching, meshes of processes, the
multi-process runtime, checkpoints, and one map sharded over processes with
its halo exchanges."""

from .mesh import make_mesh  # noqa: F401
from .batch import init_batch, batched_update, batched_move_to, batched_input_image, shard_states, batch_stats  # noqa: F401
from . import distributed  # noqa: F401
from . import checkpoint  # noqa: F401
from . import halo, sharded_scatter, spatial  # noqa: F401
from .spatial import (  # noqa: F401
    shard_state_spatial, spatial_update_pointcloud, shard_states_spatial_batched,
    batched_spatial_update_pointcloud, gather_spatial, spatial_move_to,
)
