"""The least time the sweep's work needs on the card, counted from the
problem, not from the kernel that does it.

The work of one trace of S sources over the extents [-Rb, Rf] (per
axis) is, for every cell of each source's box and every node of every
live band (the rule's K nodes a band, the bands a blackbody of the
configured temperature reaches: radiation_tables.f90:194-199):

- 2 exponentials (the attenuation in and out of the cell), on the
  special-function units;
- 10 float32 operations for the photo-ionization sums, 25 with heating
  (the three species' heating sums and the secondary ionization);
- with a per-cell LLS column, one more exponential a cell.

Its bytes are the field channels (density and four fractions, and the
LLS column where there is one) read once and the four rate grids
written once, over the cells the sources' boxes cover (at most the
grid).  The least time of a trace is the largest of operations over
peak float32 rate, exponentials over the special-function rate, and
bytes over the memory bandwidth (`peaks.json`).
"""

import json
from pathlib import Path

from reference.plain import constants as const
from reference.plain.radiation.bands import make_bands

NODES = 6          # the Gauss-Legendre rule Run3D builds
FLOPS_NODE = 10
FLOPS_NODE_HEAT = 25
SFU_NODE = 2
FIELDS = 5
RATES = 4
ITEMSIZE = 4       # float32

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def live_bands(t_eff: float) -> int:
    """Bands a blackbody of temperature `t_eff` reaches: up to the first
    whose lower edge has h nu / kT > 25 (radiation_tables.f90:194-199)."""
    bands = make_bands()
    h_over_kT = const.hplanck / (const.k_B * t_eff)
    for b in range(bands.nbands):
        if bands.freq_min[b] * h_over_kT > 25.0:
            return b
    return bands.nbands


def trace_work(run3d: dict, S: int, Rf: int, Rb: int, lls: bool) -> dict:
    """Operations, exponentials and bytes of one trace call."""
    M = int(run3d["mesh"])
    nb = live_bands(float(run3d["sed"]["bb"]["T_eff"]))
    heat = not run3d.get("isothermal", True)
    box = min(Rf + Rb + 1, M) ** 3
    pairs = S * box
    nodes = nb * NODES
    flops = pairs * nodes * (FLOPS_NODE_HEAT if heat else FLOPS_NODE)
    sfu = pairs * (nodes * SFU_NODE + (1 if lls else 0))
    cells = min(M**3, pairs)
    nbytes = cells * ITEMSIZE * (FIELDS + (1 if lls else 0) + RATES)
    return dict(flops=flops, sfu=sfu, bytes=nbytes)


def least_seconds(run3d: dict, traces) -> tuple:
    """(least seconds, what bounds most of it) of the trace calls
    [(S, Rf, Rb, lls), ...]."""
    total = 0.0
    by = {"flops": 0.0, "sfu": 0.0, "bytes": 0.0}
    for S, Rf, Rb, lls in traces:
        w = trace_work(run3d, S, Rf, Rb, lls)
        t = {"flops": w["flops"] / PEAKS["float32_flops_per_s"],
             "sfu": w["sfu"] / PEAKS["sfu_ops_per_s"],
             "bytes": w["bytes"] / PEAKS["bytes_per_s"]}
        k = max(t, key=t.get)
        total += t[k]
        by[k] += t[k]
    return total, max(by, key=by.get)
