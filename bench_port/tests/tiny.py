"""A cell of the benchmark cut to a size the CPU tests can hold: its
network, elements, quadrature, test functions and boundary points made
small, everything else (the program's path, the traffic, the limits) the
cell's own."""

import copy

from bench_port import cell as cells

SIZES = dict(layers=[2, 8, 8, 1], n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, n_bound=10)


def tiny_cell(workload: str, ranks: int | None = None) -> dict:
    c = copy.deepcopy(cells.load(workload))
    c["config"]["program"]["fields"].update(SIZES)
    c["traffic"]["trace_seconds"] = 0.2
    if ranks is not None:
        c["traffic"]["ranks"] = ranks
    return c
