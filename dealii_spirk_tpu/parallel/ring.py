"""Ring-rotation stage mixing over the device mesh.

Port of ``matrix_vector_rol_operation`` (reference
``main.cc:1443-1534``): the dense q x q stage coupling ``out_i = sum_j
mat[i, j] W_j`` executes as q-1 ``ppermute`` steps around the stage axis
with rotate-and-accumulate — structurally the ring-attention pattern, and
the literal translation of the reference's ``MPI_Sendrecv_replace`` ring.

Two execution strategies, mirroring the reference's option pair:

* ``UseSharedMemory = false`` -> this ring (per-step neighbor exchange),
* ``UseSharedMemory = true``  -> plain einsum, which XLA lowers to an
  all-gather (the analog of reading peer stage data directly
  from an MPI shared-memory window, reference ``main.cc:1506-1533``).

Both are numerically identical; tests assert so on the CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def ring_stage_mix(mat, W, mesh: Mesh):
    """out_i = sum_j mat[i, j] W_j with W (q, *spatial), stage-sharded.

    Requires the stage mesh axis extent to equal q (one stage per group,
    like the reference's rank groups).  ``mat`` is replicated.
    """
    q = W.shape[0]
    if mesh.shape["stage"] != q:
        raise ValueError(
            f"ring mixing needs stage axis == q ({mesh.shape['stage']} != {q})"
        )

    # only the stage axis is manual; the space axis stays under the
    # automatic SPMD partitioner (odd interior extents are not divisible
    # by the space axis, which strict shard_map would reject)
    spec = P("stage")

    def body(mat_local, W_local):
        # W_local: (1, *local_spatial) — this group's stage block
        i = lax.axis_index("stage")
        perm = [(k, (k + 1) % q) for k in range(q)]
        acc = jnp.zeros_like(W_local)
        cur = W_local
        for step in range(q):
            j = (i - step) % q  # owner of the block currently held
            coeff = jax.lax.dynamic_index_in_dim(
                jax.lax.dynamic_index_in_dim(mat_local, i, 0, keepdims=False),
                j,
                0,
                keepdims=False,
            )
            acc = acc + coeff * cur
            if step < q - 1:
                cur = lax.ppermute(cur, "stage", perm)
        return acc

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), spec),
        out_specs=spec,
        axis_names={"stage"},
        check_vma=False,
    )(mat, W)
