"""2D device table: the reference builds ``irk-2D`` as a co-equal
executable (reference CMakeLists.txt:38-46); this sweeps ``irk_batched``
in 2D on the GPU — degree x refinement — and prints per-step time,
outer/inner iteration totals and the L2 error per row.

Timing: bench._time_scheme (two-point in-graph slope).  Exits non-zero
when JAX finds no GPU.

Usage: python -u scripts/sweep_2d.py [p:ref ...]
       (default: 1:9 1:10 1:11 1:12 2:10 3:9 4:9 — per-stage DoFs from
        0.26M to 16.8M; the p >= 2 rows sit at ~2-4M like the 3D table)
Not part of the test suite — a perf-engineering tool.
"""

from __future__ import annotations

import sys

sys.path.insert(0, ".")

import jax  # noqa: E402


def main():
    combos = sys.argv[1:] or [
        "1:9", "1:10", "1:11", "1:12", "2:10", "3:9", "4:9",
    ]
    from bench import _time_scheme
    from dealii_spirk_tpu.utils.compile_cache import enable_compile_cache
    from dealii_spirk_tpu.utils.gpu import card_lines, require_gpu

    require_gpu()
    enable_compile_cache()
    print(f"device: {jax.devices()[0]} {' | '.join(card_lines())} "
          "(irk_batched, 2D, q=4, f32)")
    print(f"{'p':>2} {'ref':>3} {'DoF/stage':>10} | {'ms/step':>9} | "
          f"{'out/in':>7} {'L2':>10}")
    for combo in combos:
        p, ref = (int(v) for v in combo.split(":"))
        m = p * 2**ref - 1
        t, n, _, err = _time_scheme("irk_batched", ref, degree=p, dim=2)
        print(f"{p:>2} {ref:>3} {m * m:>10} | {t * 1e3:>9.3f} | "
              f"{n.outer}/{n.inner} {float(err[0]):>10.4e}")


if __name__ == "__main__":
    main()
