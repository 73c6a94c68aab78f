"""Host time of the driver's slice loop per step: the window's wall
less the synchronised walls of its evolve3d calls (prepare_slice,
slice_sources and the suppression on a host copy of the ionized
fraction, the clock, the photon budget, the cycle's reset), in ms."""


def read(trace):
    c = trace["counts"]
    if not c["steps"] or not c["evolve_s"]:
        return None
    return (c["window_s"] - c["evolve_s"]) / c["steps"] * 1e3
