"""Traffic small enough for a run of a cell on the CPU at the program's
smoke size (the tests' sizes; the cells' own are in ``traffic/``)."""

SMALL = {
    "pde_solver.infer": {"points": 64, "pool": 2},
    "pde_solver.train": {"points": 64},
}
