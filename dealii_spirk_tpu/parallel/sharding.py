"""Sharding rules for problem arrays on the (stage, space) mesh.

The reference's data distribution (SURVEY.md §2.3) maps as:

* spatial domain decomposition -> first spatial axis sharded on "space",
* stage parallelism -> leading stage/pair axis sharded on "stage",
* stage mixing (T / T^{-1} / A^{-1} ring rotations) -> einsum over the
  stage axis; XLA lowers it to an all-gather,
* ReshapedVector reductions spanning both axes -> psum over the whole
  mesh, inserted automatically for jnp reductions under SPMD.
"""

from __future__ import annotations

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def space_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for a (*spatial) solution array: first spatial axis on
    "space" (the reference's comm_column domain decomposition)."""
    return NamedSharding(mesh, P("space", *(None,) * (ndim - 1)))


def stage_block_sharding(
    mesh: Mesh, ndim: int, spatial_start: int = 1
) -> NamedSharding:
    """Sharding for a (stage, *rest) block array: stage axis on "stage",
    first spatial axis on "space".

    ``spatial_start`` is the index of the first spatial axis: 1 for plain
    stage blocks (stage, *spatial), 2 for complex pair blocks
    (stage, 2, *spatial) whose re/im axis stays replicated.
    """
    spec = ["stage"] + [None] * (ndim - 1)
    spec[spatial_start] = "space"
    return NamedSharding(mesh, P(*spec))
