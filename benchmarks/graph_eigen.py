#!/usr/bin/env python
"""Graph-algorithm and eigensolver timings
(parity: performance/{graph,eigen})."""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def bench_graph(grid: int = 100):
    from cusp_autotuned_tpu import gallery, graph

    G = gallery.grid2d(grid, grid, format="csr")
    print(f"# graph algorithms on grid2d({grid}x{grid}), "
          f"{G.num_rows} vertices")
    for name, fn in [
        ("bfs", lambda: graph.breadth_first_search(G, 0)),
        ("connected_components", lambda: graph.connected_components(G)),
        ("mis(1)", lambda: graph.maximal_independent_set(G, 1)),
        ("mis(2)", lambda: graph.maximal_independent_set(G, 2)),
        ("vertex_coloring", lambda: graph.vertex_coloring(G)),
        ("symmetric_rcm", lambda: graph.symmetric_rcm(G)),
    ]:
        t0 = time.perf_counter()
        fn()
        print(f"  {name:22s} {(time.perf_counter()-t0)*1e3:9.1f} ms")


def bench_eigen(grid: int = 60):
    from cusp_autotuned_tpu import eigen, gallery

    A = gallery.poisson5pt(grid, grid, format="csr", dtype=np.float64)
    print(f"# eigensolvers on poisson5pt({grid}x{grid})")
    for name, fn in [
        ("gershgorin", lambda: eigen.disks_spectral_radius(A)),
        ("power(20)", lambda: eigen.estimate_spectral_radius(A, 20)),
        ("ritz(10)", lambda: eigen.ritz_spectral_radius(A, 10)),
        ("lanczos(60)", lambda: eigen.lanczos(
            A, eigen.LanczosOptions(iteration_limit=60))),
        ("lobpcg", lambda: eigen.lobpcg(A, maxiter=100)),
    ]:
        t0 = time.perf_counter()
        out = fn()
        print(f"  {name:14s} {(time.perf_counter()-t0)*1e3:9.1f} ms")


if __name__ == "__main__":
    bench_graph()
    bench_eigen()
