"""1D output streams + photon statistics.

Port of ``c2ray_tpu/onedim/output.py`` (``code/files_for_1D/output.f90``:
radial profile files `Ifront1_<step>.dat` with the analytic/numerical
front comparison; ``code/files_for_1D/photonstatistics.f90``: per-species
inventory deltas balanced against emitted photons).  Host code: the
state is copied to float64 numpy once per call, so the files are the
JAX package's byte for byte.
"""

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..rates import rate_coefficients
from .analytic import analytic_front, numerical_front
from .driver import OneDRun


def _np(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().cpu(), dtype=np.float64)


def write_profile(run: OneDRun, step: int, results_dir="./results/"):
    """`Ifront1_<step>.dat`: r, xh0, xh1, [T,] n, xhe0..2 per shell
    (output.f90:148-191)."""
    os.makedirs(results_dir, exist_ok=True)
    x = run.grid.x
    s = run.state
    xh, xhe = _np(s.xh), _np(s.xhe)
    cols = [xh[:, 0], xh[:, 1], _np(s.ndens), xhe[:, 0], xhe[:, 1],
            xhe[:, 2]]
    if not run.problem.isothermal:
        cols.insert(2, _np(s.temper))
    path = os.path.join(results_dir, f"Ifront1_{step}.dat")
    with open(path, "w") as f:
        for i in range(run.grid.mesh):
            f.write(f"{x[i]:12.5e} "
                    + " ".join(f"{c[i]:10.3e}" for c in cols) + "\n")
    return path


class FrontComparison(NamedTuple):
    numerical: float
    analytic: float
    relative_error: float


def front_comparison(run: OneDRun, xlimit=0.5) -> FrontComparison:
    """Numerical vs analytic I-front position (output.f90:302-433)."""
    nf = numerical_front(run.grid.x, run.grid.dr, _np(run.state.xh)[:, 1],
                         xlimit)
    kwargs = {}
    if run.problem.testnum == 4:
        kwargs = dict(zred=float(run.clock.zred), t0=run.clock.t0)
    af = analytic_front(run.problem, run.sed.bb.S_star, run.time, **kwargs)
    return FrontComparison(numerical=nf, analytic=af,
                           relative_error=abs(nf - af) / af)


class PhotonStats1D(NamedTuple):
    """Species inventory deltas over a step
    (files_for_1D/photonstatistics.f90:41,95-102)."""

    dh0: float
    dhe0: float
    dhe2: float
    total_ion: float
    totrec: float
    total_src: float
    photon_conservation: float


def photon_statistics_1d(run: OneDRun, state_before, dt) -> PhotonStats1D:
    """Balance new ionizations + recombinations against emitted photons
    using shell volumes (photonstatistics.f90 1D variant)."""
    vol = run.grid.vol
    s0, s1 = state_before, run.state
    nd = _np(s1.ndens)

    def inv(st, sp, frac_idx, abundance):
        arr = _np(getattr(st, sp))[:, frac_idx]
        return float(np.sum(_np(st.ndens) * arr * vol) * abundance)

    dh0 = inv(s0, "xh", 0, const.abu_h) - inv(s1, "xh", 0, const.abu_h)
    dhe0 = inv(s0, "xhe", 0, const.abu_he) - inv(s1, "xhe", 0, const.abu_he)
    dhe2 = inv(s1, "xhe", 2, const.abu_he) - inv(s0, "xhe", 2, const.abu_he)
    total_ion = dh0 + dhe0 + dhe2

    r = rate_coefficients(torch.tensor(run.problem.temper_val,
                                       dtype=torch.float64))
    xh1 = _np(s1.xh)[:, 1]
    ne = nd * (xh1 * const.abu_h + const.abu_c)
    totrec = float(np.sum(nd * xh1 * float(r.brech0) * const.abu_h * ne
                          * run.problem.clumping * vol) * dt)

    total_src = run.sed.bb.S_star * dt if run.sed.bb else 0.0
    cons = (total_ion + totrec) / max(total_src, 1e-300)
    return PhotonStats1D(dh0=dh0, dhe0=dhe0, dhe2=dhe2,
                         total_ion=total_ion, totrec=totrec,
                         total_src=total_src, photon_conservation=cons)
