"""1D program driver: init + time loop.

Port of ``c2ray_tpu/onedim/driver.py`` (``code/files_for_1D/C2Ray.F90``,
program C2Ray 1D, and the 1D times module ``code/time.F90``: end time +
N equal steps).  Tables and state live on the device `setup` is given:
the card ("cuda", the default, where `evolve1d` launches the kernel) or,
when asked for, the CPU (the plain version).
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..cooling import setup_cooling_tables
from ..cosmology import CosmoClock
from ..driver import _device_of
from ..grid import RadialGrid
from ..radiation.bands import make_bands
from ..radiation.quadrature import build_quadrature_tables
from ..radiation.sed import SEDConfig
from ..radiation.tables import build_radiation_tables
from .evolve import OneDContext, State1D, evolve1d
from .material import OneDProblem, init_material


def _scaled_volumes(grid: RadialGrid, flux_scale, dtype, device):
    """Shell volumes divided by the tables' flux scale on the host in
    float64 (raw kpc-scale shell volumes ~1e66 cm^3 overflow float32;
    the scaled tables make the product physical)."""
    return torch.as_tensor(np.asarray(grid.vol, dtype=np.float64)
                           / flux_scale, dtype=dtype, device=device)


@dataclass
class OneDRun:
    """A configured 1D simulation (grid + material + radiation)."""

    problem: OneDProblem
    grid: RadialGrid
    sed: SEDConfig
    ctx: OneDContext = None
    state: State1D = None
    clock: Optional[CosmoClock] = None
    time: float = 0.0
    # the last step's evolve1d counters: [summed iterations, largest
    # iterations of a shell, largest and summed thermal sub-steps]
    last_counters: Optional[torch.Tensor] = None

    @classmethod
    def setup(cls, problem: OneDProblem, grid: RadialGrid, sed: SEDConfig,
              nbnd2: int = 26, nbnd3: int = 20, dtype=torch.float64,
              use_quadrature: bool = True, device="cuda") -> "OneDRun":
        """Init sequence (files_for_1D/C2Ray.F90:70-125).

        ``use_quadrature``: evaluate band integrals with the exponential
        sum rule (more accurate than the reference's tau-table
        interpolation); False selects the table route for
        reference-parity studies.  ``device``: "cuda" (the default; the
        kernel) raises without CUDA; "cpu" runs the plain version.
        """
        dev = _device_of(device)
        bands = make_bands(nbnd2, nbnd3)
        build = (build_quadrature_tables if use_quadrature
                 else build_radiation_tables)
        tables, sed_norm, bands = build(
            sed, bands, isothermal=problem.isothermal, dtype=dtype,
            device=dev)
        cooling = (None if problem.isothermal
                   else setup_cooling_tables(dtype=dtype, device=dev))

        ndens, temper, xh, xhe = init_material(problem, grid)

        clock = None
        cosmo_cool_factor = 0.0
        if problem.testnum == 4:
            clock = CosmoClock.init(problem.cosmology, problem.zred00)
            clock, zfactor, _ = clock.redshift_evol(0.0)
            # comoving -> proper: lengths shrink by 1/(1+z), density grows
            ndens = ndens / zfactor**3
            grid = RadialGrid(r_in=grid.r_in * zfactor,
                              r_out=grid.r_out * zfactor, mesh=grid.mesh)
            cosmo_cool_factor = float(clock.cosmo_cool_rate(1.0))

        fscale = float(getattr(bands, "flux_scale", 1.0) or 1.0)
        ctx = OneDContext(
            tables=tables,
            cooling=cooling,
            dr=grid.dr,
            vol=_scaled_volumes(grid, fscale, dtype, dev),
            flux_scale=fscale,
            clumping=problem.clumping,
            isothermal=problem.isothermal,
            gamma_uvb=problem.gamma_uvb,
            epsilon=problem.epsilon,
            cosmo_cool_factor=cosmo_cool_factor,
            has_bb=sed.bb is not None,
            has_pl=sed.pl is not None,
            has_qso=sed.qso is not None,
        )
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                         dtype=dtype, device=dev)
        state = State1D(ndens=as_t(ndens), temper=as_t(temper), xh=as_t(xh),
                        xhe=as_t(xhe))
        return cls(problem=problem, grid=grid, sed=sed_norm, ctx=ctx,
                   state=state, clock=clock)

    def step(self, dt: float):
        """One timestep (C2Ray.F90 1D:131-169); returns the per-shell
        iteration counts.

        Cosmological rescaling for test 4 (redshift_evol + cosmo_evol at
        mid-step, C2Ray.F90 1D:158-161) is applied to the density and the
        grid; the new dr and shell volumes (host float64, / flux_scale)
        go to the next launch as arguments: nothing is compiled per step.
        """
        if self.clock is not None:
            self.clock, zfactor, _ = self.clock.redshift_evol(
                self.time + 0.5 * dt)
            zf3 = zfactor**3
            self.state = self.state._replace(ndens=self.state.ndens / zf3)
            g = self.grid
            self.grid = RadialGrid(r_in=g.r_in * zfactor,
                                   r_out=g.r_out * zfactor, mesh=g.mesh)
            self.ctx = replace(self.ctx, dr=self.grid.dr,
                               vol=_scaled_volumes(
                                   self.grid, self.ctx.flux_scale,
                                   self.state.ndens.dtype,
                                   self.state.ndens.device))

        self.state, nits, self.last_counters = evolve1d(self.ctx, self.state,
                                                        dt)
        self.time += dt
        return nits

    def run(self, end_time: float, num_steps: int):
        """Equal-step loop (time.F90:35-125)."""
        dt = end_time / num_steps
        for _ in range(num_steps):
            self.step(dt)
        return self.state
