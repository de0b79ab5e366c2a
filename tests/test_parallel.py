"""Multi-device tests on the virtual 8-device CPU mesh — the stand-in
for multi-node runs (SURVEY.md §4, item 5)."""

import jax
import numpy as np
import pytest

from dealii_spirk_tpu.config import Parameters
from dealii_spirk_tpu.parallel.mesh import make_mesh, stage_space_shape
from dealii_spirk_tpu.runner import run_config

BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "IRKStages": 4,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "DoOutputParaview": False,
}


def _run(over, dim=2, mesh=None):
    p = Parameters.from_dict({**BASE, **over}, dim=dim)
    return run_config(p, mesh=mesh, verbose=False)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_mesh_shapes():
    assert stage_space_shape(8, 4) == (4, 2)
    assert stage_space_shape(8, 2) == (2, 4)
    assert stage_space_shape(8, 3) == (3, 2)  # 2 devices dropped
    with pytest.raises(ValueError):
        stage_space_shape(2, 4)
    m = make_mesh(4)
    assert m.shape == {"stage": 4, "space": 2}
    # MaxRanks trimming (reference main.cc:3647-3658)
    m2 = make_mesh(2, max_ranks=4)
    assert m2.shape == {"stage": 2, "space": 2}


def test_spirk_matches_irk():
    """Stage-parallel IRK must reproduce sequential IRK exactly —
    same errors AND same iteration counts (the reference's schemes are
    mutual oracles, SURVEY.md §4.4)."""
    seq = _run({"TimeIntegrationScheme": "irk"})
    par = _run({"TimeIntegrationScheme": "spirk"})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]


def test_complex_spirk_matches_complex_irk():
    seq = _run({"TimeIntegrationScheme": "complex_irk"})
    par = _run({"TimeIntegrationScheme": "complex_spirk"})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]


def test_complex_spirk_batched():
    """First-class oracle: the stage-parallel batched complex scheme must
    match its sequential sibling in errors AND iteration counts — pair
    GMRES counts and the per-pair split included (reference
    main.cc:2382-2934 + the batched block-GMG at :2168-2182)."""
    seq = _run({"TimeIntegrationScheme": "complex_irk_batched"})
    par = _run({"TimeIntegrationScheme": "complex_spirk_batched"})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    np.testing.assert_array_equal(
        par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage
    )


def test_spirk_inner_tolerance_matches_irk():
    """The InnerTolerance > 0 stage-parallel path (reference
    main.cc:1661-1693): concurrent per-stage inner CG solves whose lanes
    CONVERGE AT DIFFERENT ITERATION COUNTS and must freeze independently
    while sharded over the stage mesh axis.  At 1e-4 on this grid the
    per-stage counts are non-uniform — a frozen lane's state leaking
    across a shard boundary would break the exact count equality."""
    over = {"InnerTolerance": 1e-4}
    seq = _run({"TimeIntegrationScheme": "irk", **over})
    par = _run({"TimeIntegrationScheme": "spirk", **over})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    np.testing.assert_array_equal(
        par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage
    )
    # the masking is only exercised if stages really differ in count
    assert len(set(seq["scheme"].n_inner_stage.tolist())) > 1


def test_spirk_inner_tolerance_q8_one_stage_per_device():
    """Same InnerTolerance > 0 path on the (8, 1) mesh — one stage per
    device, per-lane masking exactly aligned with shard boundaries."""
    over = {
        "IRKStages": 8,
        "NRefinements": 3,
        "InnerTolerance": 1e-4,
    }
    seq = _run({"TimeIntegrationScheme": "irk", **over})
    par = _run({"TimeIntegrationScheme": "spirk", **over})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    np.testing.assert_array_equal(
        par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage
    )


def test_spirk_shared_memory_option():
    """UseSharedMemory toggles all-gather vs ring stage mixing (reference
    main.cc:1506-1533 vs :1443-1484); results identical."""
    ring = _run({"TimeIntegrationScheme": "spirk", "UseSharedMemory": False})
    sm = _run({"TimeIntegrationScheme": "spirk", "UseSharedMemory": True})
    np.testing.assert_allclose(sm["error_L2"], ring["error_L2"], rtol=1e-10)
    assert sm["n_outer"] == ring["n_outer"]


def test_spirk_column_major_topology():
    """DoRowMajor toggles device placement (reference main.cc:281-293);
    results must be identical either way."""
    a = _run({"TimeIntegrationScheme": "spirk", "DoRowMajor": True})
    b = _run({"TimeIntegrationScheme": "spirk", "DoRowMajor": False})
    np.testing.assert_allclose(a["error_L2"], b["error_L2"], rtol=1e-12)


def test_spirk_3d():
    out = _run(
        {"TimeIntegrationScheme": "spirk", "NRefinements": 3, "IRKStages": 2},
        dim=3,
    )
    assert out["error_L2"] < 0.1


def test_spirk_q8_full_stage_mesh():
    """q=8 on an (8, 1) mesh — one stage per device, the reference's
    canonical stage-parallel layout (ring mixing active)."""
    out = _run(
        {
            "TimeIntegrationScheme": "spirk",
            "IRKStages": 8,
            "NRefinements": 3,
            "TimeStepSize": 0.1,
            "EndTime": 0.2,
        }
    )
    seq = _run(
        {
            "TimeIntegrationScheme": "irk_batched",
            "IRKStages": 8,
            "NRefinements": 3,
            "TimeStepSize": 0.1,
            "EndTime": 0.2,
        }
    )
    np.testing.assert_allclose(out["error_L2"], seq["error_L2"], rtol=1e-9)
    assert out["n_outer"] == seq["n_outer"]


def test_stage_axis_adjacency_row_major():
    """Row-major placement puts each stage group on CONSECUTIVE device
    ids — the reference's
    virtual-topology intent (lex_to_pair, main.cc:281-293)."""
    mesh = make_mesh(4, do_row_major=True)
    ids = np.array([[d.id for d in row] for row in mesh.devices])
    # each space column holds consecutive ids along the stage axis
    for j in range(ids.shape[1]):
        col = ids[:, j]
        assert list(col) == list(range(col[0], col[0] + len(col))), ids


def test_padding_drops_node_straddlers():
    """Padding=P keeps only (P // s) * s devices per node of P, so a
    stage group never straddles a node boundary (reference
    create_rectangular_comm, main.cc:365-405)."""
    devices = jax.devices()  # 8 virtual CPU devices
    mesh = make_mesh(3, devices=devices, padding=4)
    ids = sorted(d.id for d in mesh.devices.flat)
    # nodes {0..3}, {4..7}: keep first 3 of each node, then trim to a
    # 3 x 2 rectangle
    assert ids == [0, 1, 2, 4, 5, 6]
    assert dict(mesh.shape) == {"stage": 3, "space": 2}


def test_padding_default_keeps_everything():
    m_def = make_mesh(4, padding=-1)
    assert len(list(m_def.devices.flat)) == 8


def test_padding_smaller_than_stages_raises():
    with pytest.raises(ValueError, match="at least as large"):
        make_mesh(4, padding=2)


def test_padding_zero_is_devices_per_host():
    """Padding=0 resolves the node size to the number of devices on the
    first host — the reference's shared-memory-size analog
    (n_procs_of_sm, main.cc:424-442, resolution main.cc:3681-3685)."""
    from dealii_spirk_tpu.parallel.mesh import pad_devices

    # the 8 virtual CPU devices all live in process 0 -> pad = 8, and
    # (8 // 2) * 2 = 8 keeps everything
    devices = jax.devices()
    assert pad_devices(devices, 2, 0) == list(devices)

    # heterogeneous hosts: 4 devices per process -> node size 4; with a
    # stage axis of 3, keep the first 3 of each node
    class _D:
        def __init__(self, pid):
            self.process_index = pid

    fake = [_D(i // 4) for i in range(8)]
    kept = pad_devices(fake, 3, 0)
    assert [fake.index(d) for d in kept] == [0, 1, 2, 4, 5, 6]


def test_stage_mixers_lower_to_intended_collectives():
    """Virtual-topology evidence (reference main.cc:1443-1534): the ring
    mixer lowers to XLA collective-permute (the MPI_Sendrecv_replace ring
    analog) and the UseSharedMemory mixer to all-gather (the
    shared-memory direct-read analog).  This pins the communication
    PATTERN; timing it needs several cards."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dealii_spirk_tpu.parallel.ring import ring_stage_mix
    from dealii_spirk_tpu.schemes.base import stage_mix

    q = 4
    mesh = make_mesh(q)  # (stage=4, space=2)
    mat = jnp.eye(q, dtype=jnp.float32)
    W = jnp.zeros((q, 16, 16), jnp.float32)
    sh = NamedSharding(mesh, P("stage"))

    ring_lowered = jax.jit(lambda m, w: ring_stage_mix(m, w, mesh)).lower(
        mat, jax.device_put(W, sh)
    )
    # the ring's q-1 hops are explicit collective_permutes in the lowered
    # StableHLO (stable across XLA rewrites);
    # the compiled text is checked presence-only
    assert ring_lowered.as_text().count("collective_permute") >= q - 1
    ring_hlo = ring_lowered.compile().as_text()
    assert "collective-permute" in ring_hlo
    assert "all-gather" not in ring_hlo

    sm_hlo = (
        jax.jit(stage_mix, in_shardings=(None, sh), out_shardings=sh)
        .lower(mat, W)
        .compile()
        .as_text()
    )
    assert "all-gather" in sm_hlo
    assert "collective-permute" not in sm_hlo


def test_stencil_vcycle_collective_pattern():
    """Pin what the stage-batched stencil V-cycle — the solve's hot loop —
    lowers to on the (4, 2) mesh with the stage axis on "stage" and z on
    "space": the z sweeps exchange halo planes by collective-permute, the
    z restriction is a partial-sum all-reduce of a coarse-z-extent block,
    and no field is all-gathered (reference ghost exchange,
    operator.h:379-421)."""
    import re

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dealii_spirk_tpu.fem.grid import make_space
    from dealii_spirk_tpu.solvers.gmg import (
        build_gmg_data,
        gmg_reinit,
        vcycle,
    )

    mesh = make_mesh(4)
    assert dict(mesh.shape) == {"stage": 4, "space": 2}
    space = make_space(3, 1, 4)  # 15^3 per stage
    gmg = build_gmg_data(space, dtype=jnp.float32, with_dense=False)
    shifts = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)
    prec = gmg_reinit(gmg, shifts, 0.1, 3, batch=True)
    spec = NamedSharding(mesh, P("stage", "space", None, None))
    pin = lambda x: jax.lax.with_sharding_constraint(x, spec)
    # reduce the result so no output relayout adds collectives of its own
    hlo = (
        jax.jit(
            lambda rr, pr: jnp.sum(
                pin(vcycle(gmg, pr, shifts, 0.1, pin(rr), 3, batch=True))
                ** 2
            )
        )
        .lower(jnp.ones((4,) + space.shape, jnp.float32), prec)
        .compile()
        .as_text()
    )

    def collectives(kind):
        pat = rf"= \w+\[([\d,]*)\][^\n]*? {kind}(?:-start)?\("
        return [
            [int(x) for x in m.split(",") if x] for m in re.findall(pat, hlo)
        ]

    assert collectives("all-gather") == []
    assert collectives("all-to-all") == []
    permutes = collectives("collective-permute")
    assert permutes
    for shape in permutes:  # (stage, planes, y, x): 1-2 halo planes
        assert shape[0] == 1 and shape[1] <= 2, shape
    fine_block = 15 * 15 * 15
    for shape in collectives("all-reduce"):
        assert int(np.prod(shape)) < fine_block, shape


def test_complex_spirk_inner_tolerance_matches_complex_irk():
    """InnerTolerance > 0 for the complex family on the mesh: PRESB's
    per-pair masked inner CG lanes (reference main.cc:2294-2335) freeze independently while sharded
    over the PAIR axis; outer counts per pair are non-uniform and the
    totals must equal sequential complex_irk's exactly."""
    over = {"InnerTolerance": 1e-4}
    seq = _run({"TimeIntegrationScheme": "complex_irk", **over})
    par = _run({"TimeIntegrationScheme": "complex_spirk", **over})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    np.testing.assert_array_equal(
        par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage
    )
    # the tolerance must actually bite (vs the tol-0 single-V-cycle path)
    # and the per-pair outer counts must differ between pairs, or the
    # masking isn't exercised
    n2 = par["scheme"].n_pairs
    pair_counts = np.asarray(par["scheme"].n_inner_stage)[:n2]
    assert len(set(pair_counts.tolist())) > 1, pair_counts


def test_complex_spirk_batched_inner_tolerance_matches():
    """_batched complex with InnerTolerance > 0: the reference's batched
    preconditioner is a block V-cycle that ignores InnerTolerance
    (main.cc:2168-2182) — counts must equal the sequential batched
    scheme's (and implicitly the tol-0 run's)."""
    over = {"InnerTolerance": 1e-4}
    seq = _run({"TimeIntegrationScheme": "complex_irk_batched", **over})
    par = _run({"TimeIntegrationScheme": "complex_spirk_batched", **over})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    np.testing.assert_array_equal(
        par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage
    )


def test_spirk_ragged_mesh_q3_drops_devices():
    """q=3 on 8 devices -> a (3, 2) mesh with 2 devices DROPPED — the
    reference's rectangular-communicator trimming end-to-end
    (main.cc:365-405): the scheme must still
    reproduce sequential irk exactly."""
    over = {"IRKStages": 3}
    seq = _run({"TimeIntegrationScheme": "irk", **over})
    par = _run({"TimeIntegrationScheme": "spirk", **over})
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    assert par["n_outer"] == seq["n_outer"]
    assert par["n_inner"] == seq["n_inner"]
    # the mesh really is ragged: 3 x 2 out of 8
    assert par["scheme"].mesh is not None
    assert dict(par["scheme"].mesh.shape) == {"stage": 3, "space": 2}
