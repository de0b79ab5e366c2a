"""Device-mesh topology and sharding rules.

Counterpart of the reference's L1 communicator-topology layer
(reference ``main.cc:277-446``): the 2D processor grid (stage x space)
becomes a ``jax.sharding.Mesh`` with axes ``("stage", "space")``; rank
placement / padding / shared-memory machinery map to mesh-axis ordering
over the device list.
"""

from .mesh import make_mesh, stage_space_shape
from .sharding import (
    space_sharding,
    stage_block_sharding,
)

__all__ = [
    "make_mesh",
    "stage_space_shape",
    "space_sharding",
    "stage_block_sharding",
]
