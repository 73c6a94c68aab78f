"""Iterations of evolve3d's convergence loop per timestep
(Evolve3DStats.n_iterations over the window's steps)."""


def read(trace):
    c = trace["counts"]
    if not c["steps"]:
        return None
    return c["iterations"] / c["steps"]
