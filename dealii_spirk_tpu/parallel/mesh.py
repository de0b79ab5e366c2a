"""Mesh construction: the (stage, space) processor grid on devices.

Replaces ``create_rectangular_comm`` / ``create_row_comm`` /
``create_column_comm`` (reference ``main.cc:277-446``, wired in ``main()``
at ``main.cc:3645-3698``): given D devices and a stage-axis extent s
(q for spirk, ceil(q/2) for complex_spirk, 1 otherwise — reference
``main.cc:3660-3666``), build a Mesh of shape (s, D // s).  Devices that
would not fit a full rectangle are dropped, mirroring the reference's
rectangular-communicator trimming (``main.cc:365-405``).

``do_row_major`` controls which axis varies fastest in device order — the
analog of the reference's virtual-topology placement (``lex_to_pair``,
``main.cc:281-293``): row-major puts consecutive devices along the stage
axis.  **Stage-axis adjacency guarantee (tested)**: with row-major
placement, each stage group occupies CONSECUTIVE entries of the device
list.  The four GPUs of one host are joined all to all by NVLink, so
every placement reaches its peers at the same rate; the order matters
only where devices sit in a hierarchy (several hosts).

``padding`` is the reference's node-boundary padding (``main.cc:3681-3685``
+ ``create_rectangular_comm`` ``main.cc:365-405``): devices are grouped
into "nodes" of ``padding`` entries and only the first
``(padding // s) * s`` of each node are used, so a stage group never
straddles a node boundary.  ``-1`` = no padding (node size = s, keeps
everything), ``0`` = devices-per-host (the shared-memory-size analog),
``> 0`` = explicit node size.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def stage_space_shape(
    n_devices: int, stage_size: int, max_ranks: int = 0
) -> tuple[int, int]:
    if max_ranks:
        n_devices = min(n_devices, max_ranks)  # reference main.cc:3647-3658
    if n_devices < stage_size:
        raise ValueError(
            f"{n_devices} devices cannot host a stage axis of {stage_size} "
            f"(reference asserts the same, main.cc:3668-3669)"
        )
    return stage_size, n_devices // stage_size


def pad_devices(devices, stage_size: int, padding: int):
    """Apply the reference's rank-padding selection
    (``create_rectangular_comm``, main.cc:365-405): within each node of
    ``padding`` devices keep the first ``(padding // s) * s``."""
    s = stage_size
    if padding == -1:
        pad = s
    elif padding == 0:
        # shared-memory-size analog: devices on the first host
        first = devices[0].process_index
        pad = sum(1 for d in devices if d.process_index == first)
    else:
        pad = padding
    if pad < s:
        # reference asserts the same (main.cc:3674-3679)
        raise ValueError(
            f"Padding ({pad}) has to be at least as large as the number "
            f"of stages ({s})"
        )
    keep_per_node = (pad // s) * s
    return [d for i, d in enumerate(devices) if (i % pad) < keep_per_node]


def make_mesh(
    stage_size: int,
    *,
    devices=None,
    max_ranks: int = 0,
    do_row_major: bool = True,
    padding: int = -1,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if max_ranks:
        devices = devices[:max_ranks]  # reference trim_comm main.cc:343-361
    devices = pad_devices(devices, stage_size, padding)
    s, c = stage_space_shape(len(devices), stage_size)
    used = np.asarray(devices[: s * c])
    if do_row_major:
        grid = used.reshape(c, s).T  # consecutive devices along stage
    else:
        grid = used.reshape(s, c)
    return Mesh(grid, axis_names=("stage", "space"))
