"""Run driver: time loop, error reporting, convergence table.

Counterpart of ``HeatEquation::Problem::run`` + ``main()`` (reference
``main.cc:3014-3791``): per config build the problem, select the scheme,
interpolate the initial condition, loop timesteps with end-time
truncation, report per-step L2/Linf errors, fill one convergence-table
row, and accumulate rows across configs.
"""

from __future__ import annotations

from time import perf_counter

import jax

from .config import Parameters
from .problem import HeatProblem
from .schemes import make_scheme
from .utils.table import ConvergenceTable


def run_config(
    params: Parameters,
    table: ConvergenceTable | None = None,
    *,
    mesh=None,
    verbose: bool = True,
    output_dir: str = ".",
    profile_phases: bool = False,
) -> dict:
    """Run one configuration; returns a summary dict and fills ``table``."""
    if table is None:
        table = ConvergenceTable()

    say = print if verbose else (lambda *a, **k: None)

    if params.block_preconditioner_type == "AMG":
        # reference preconditioner.h:176-215 wraps TrilinosWrappers ML
        # AMG; here AMG = a plain-aggregation algebraic
        # hierarchy (solvers/amg.py) with Chebyshev smoothing — honest
        # AMG semantics, but iteration counts are NOT comparable to
        # Trilinos ML's smoothed-aggregation defaults (PARITY.md)
        print(
            "NOTE: BlockPreconditionerType 'AMG' runs the "
            "plain-aggregation algebraic hierarchy (solvers/amg.py), not "
            "Trilinos ML — iteration counts are not ML-comparable; see "
            "PARITY.md."
        )

    problem = HeatProblem(params)
    sp = problem.space

    if params.is_stage_parallel and mesh is None:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(
            params.stage_axis_size,
            max_ranks=params.max_ranks,
            do_row_major=params.do_row_major,
            padding=params.padding,
        )

    scheme = make_scheme(problem, params, mesh=mesh)

    say(
        "\n===========================================\n"
        f"Number of active cells: {sp.n_cells_total}\n"
        f"Number of degrees of freedom: {sp.n_dofs}\n"
    )

    if mesh is not None:
        # virtual-topology dump (reference main.cc:3700-3740): which device
        # sits at each (stage, space) coordinate
        say("Device grid (stage x space):")
        for row in mesh.devices:
            say("  " + " ".join(f"{d.id:3d}" for d in row))

    # table parity: reference main.cc:3387-3398
    n_devices = len(mesh.devices.flat) if mesh is not None else 1
    n_row = mesh.shape["stage"] if mesh is not None else 1
    n_col = mesh.shape["space"] if mesh is not None else 1
    table.add_value("n_levels", sp.refinement + 1)
    table.add_value("n_cells", sp.n_cells_total)
    table.add_value("fe_degree", params.fe_degree)
    table.add_value("n_dofs", sp.n_dofs)
    table.add_value("n_stages", params.irk_stages)
    table.add_value("n_procs", len(jax.devices()))
    table.add_value("n_procs_global", n_devices)
    table.add_value("n_procs_row", n_row)
    table.add_value("n_procs_column", n_col)

    paraview = None
    if params.do_output_paraview:
        from .utils.vtk import ParaviewSeries

        paraview = ParaviewSeries(output_dir)

    u = problem.initial_condition()
    time = 0.0
    timestep_number = 0
    error = problem.errors(u, time)
    if paraview is not None:
        paraview.write(u, sp.fine.x, time, timestep_number)
    say(f"   Error in the L2/Linf norm : {error[0]:.6e}/{error[1]:.6e}")

    dt = params.auto_time_step(sp.dx_min)
    say(f"\nStarting time loop with dt={dt}")
    if dt >= params.end_time:
        raise ValueError("time step must be smaller than the end time")

    errors_history = [error]
    # host wall time of each solve_step (it blocks until the device is
    # done); the first includes compilation and preconditioner setup
    step_seconds = []
    # reference main.cc:3326-3358: truncate the last step to land on T
    while (params.end_time - time) > (1e-4 * dt):
        if time + dt > params.end_time:
            tau = params.end_time - time
            time = params.end_time
        else:
            tau = dt
            time += dt
        say(f"\nTime step {timestep_number} at t={time:g}")
        timestep_number += 1

        t0 = perf_counter()
        u = scheme.solve_step(u, timestep_number, time, tau)
        step_seconds.append(perf_counter() - t0)

        error = problem.errors(u, time)
        errors_history.append(error)
        if paraview is not None:
            paraview.write(u, sp.fine.x, time, timestep_number)
        say(f"   Error in the L2/Linf norm : {error[0]:.6e}/{error[1]:.6e}")

    table.add_value("n_t", timestep_number)
    table.add_value("final_t", time)
    table.set_scientific("final_t", True)
    table.add_value("dt", dt)
    table.set_scientific("dt", True)
    table.add_value("error_L2", error[0])
    table.set_scientific("error_L2", True)
    table.add_value("error_Linf", error[1])
    table.set_scientific("error_Linf", True)

    if profile_phases:
        scheme.profile_phases(dt, max(timestep_number - 1, 1))
    scheme.get_statistics(table, max(timestep_number - 1, 1))
    table.commit_row()

    return {
        "n_timesteps": timestep_number,
        "dt": dt,
        "error_L2": error[0],
        "error_Linf": error[1],
        "errors": errors_history,
        "step_seconds": step_seconds,
        "outer_per_step": list(scheme.outer_per_step),
        "n_outer": scheme.n_outer,
        "n_inner": scheme.n_inner,
        "scheme": scheme,
        "table": table,
        "u": u,
    }
