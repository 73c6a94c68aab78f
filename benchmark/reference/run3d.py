"""The plain reference of one cell: what ``Run3D.run`` computes, worked
out again from the raw input files with the frozen plain code of
``reference.plain``.

`Reference` rebuilds everything the program derives from the inputs:
the rate tables, the cooling tables, the clock and the per-step cell
size, cooling factor and LLS column, the initial state (density cubes,
restart cubes), the source list (catalog, suppression, luminosities),
and then runs the plain sweep, the plain chemistry pass and the photon
budget in the dtype it is given: float64 for the reference, a lower
precision for the control.  It takes no tensor the program made except
the states it is handed to judge, and imports nothing of the program.

It sweeps with the engine the configuration selects, as ``Run3D``
does: the pyramid sweep at the full periodic extents (an even mesh, no
max_subbox below M/2 - 1), else the L1-shell sweep; either with the
step's own cell size and LLS column.
"""

import os

import numpy as np
import torch

from .plain import constants as const
from .plain.cooling import setup_cooling_tables
from .plain.cosmology import COSMOLOGIES, CosmoClock
from .plain.io.fortran_records import read_unformatted_cube
from .plain.io.readers import _zred_str, read_density_file, read_halo_catalog
from .plain.material import LLSModel, protect_ionization_fractions
from .plain.nbody import (cubep3m_nbody, gadget_nbody, pmfast_nbody,
                          test4_nbody, test_nbody)
from .plain.photonstats import photon_budget, species_inventory
from .plain.radiation.quadrature import build_quadrature_tables
from .plain.radiation.sed import BlackBodySED, PowerLawSED, SEDConfig
from .plain.rates import rate_coefficients
from .plain.sources import HaloSourceModel, apply_suppression_and_luminosities
from .plain.state import GridState, begin_timestep, finish_timestep
from .plain.state import initial_grid_state
from .plain.sweep.global_pass import ChemistryConfig, chemistry_pass_plain
from .plain.sweep.pyramid_sweep import trace_extents, trace_plain
from .plain.sweep.shell_sweep import build_shell_table, shell_plain
from .plain.sweep.source_sweep import (RateGrids, SourceFields, SweepConfig,
                                       stack_sweep_fields)


# sources traced together by the plain sweep (its per-stage tensors are
# S x 2 x (2l+1)^2 x bands x nodes: 4 sources at 250^3 fit the card)
GROUP = 4


# the N-body backends of a Run3D configuration dictionary, by type, with
# the defaults of the program's configuration loader
_NBODY = {
    "test": lambda d, cosmo: test_nbody(cosmo),
    "test4": lambda d, cosmo: test4_nbody(cosmo,
                                          d.get("data_dir", "../TEST4/")),
    "cubep3m": lambda d, cosmo: cubep3m_nbody(
        d["redshift_file"], boxsize=d.get("boxsize", 244.0),
        n_box=d.get("n_box", 8000), cosmology=cosmo,
        base_dir=d.get("base_dir", "../"),
        source_dir=d.get("source_dir", "./sources/")),
    "pmfast": lambda d, cosmo: pmfast_nbody(
        d["redshift_file"], boxsize=d.get("boxsize", 100.0),
        n_box=d.get("n_box", 3248), cosmology=cosmo,
        base_dir=d.get("base_dir", "../")),
    "gadget": lambda d, cosmo: gadget_nbody(
        d["redshift_file"], boxsize=d["boxsize"], cosmology=cosmo,
        base_dir=d.get("base_dir", "../")),
}


def _nbody(run3d: dict):
    nb = dict(run3d["nbody"])
    kind = nb.pop("type")
    if kind not in _NBODY:
        raise ValueError(f"no N-body backend {kind!r}; one of {sorted(_NBODY)}")
    return _NBODY[kind](nb, COSMOLOGIES[run3d["cosmology"]])


def _sed(d: dict) -> SEDConfig:
    """The SED of a configuration dictionary: a blackbody (`bb`), a power
    law (`pl`) and a quasar power law (`qso`), each where it is given."""
    unknown = set(d) - {"bb", "pl", "qso"}
    if unknown:
        raise ValueError(f"unknown SED components {sorted(unknown)}")
    pl = lambda k: PowerLawSED(**d[k]) if k in d else None
    return SEDConfig(bb=BlackBodySED(**d["bb"]) if "bb" in d else None,
                     pl=pl("pl"), qso=pl("qso"))


def sweep_engine(mesh: int, max_subbox=None) -> str:
    """"pyramid" at the full periodic extents, +M/2 / -(M/2 - 1), else
    "shells" (evolve_source.F90:103-109)."""
    lo = mesh // 2 - 1 + mesh % 2
    if max_subbox is not None:
        lo = min(lo, int(max_subbox))
    return "pyramid" if lo == mesh // 2 - 1 else "shells"


class Reference:
    """The plain reference of one Run3D configuration dictionary."""

    def __init__(self, run3d: dict, restart_z=None, dtype=torch.float64,
                 device="cpu", chem_max_iter=None):
        self.run3d = run3d
        self.restart_z = restart_z
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = M = int(run3d["mesh"])
        self.nbody = _nbody(run3d)
        self.cosmo = self.nbody.cosmology
        self.isothermal = bool(run3d.get("isothermal", True))
        self.cosmological = bool(run3d.get("cosmological", True))
        self.t0 = float(run3d.get("initial_temperature", 1.0e4))
        self.steps_per_slice = int(run3d.get("steps_per_slice", 2))
        sed = _sed(run3d["sed"])
        self.tables, self.sed, self.bands = build_quadrature_tables(
            sed, isothermal=self.isothermal, dtype=dtype, device=self.device)
        self.flux_scale = self.bands.flux_scale
        self.cooling = (None if self.isothermal
                        else setup_cooling_tables(dtype, self.device))
        self.dr_comoving = (self.nbody.boxsize * const.Mpc
                            / self.cosmo.h / M)
        hm = dict(run3d["halo_model"])
        hm["phot_per_atom"] = tuple(hm.get("phot_per_atom", (10.0, 150.0)))
        hm.pop("M_grid", None)
        self.halo_model = HaloSourceModel(
            M_grid=self.nbody.M_grid, Omega_B=self.cosmo.Omega_B,
            Omega0=self.cosmo.Omega0, **hm)
        self.lls_type = int(run3d.get("lls", {}).get("type_of_LLS", 0))
        max_subbox = run3d.get("max_subbox")
        self.engine = sweep_engine(M, max_subbox)
        self.shells = (build_shell_table(M, max_subbox)
                       if self.engine == "shells" else None)
        # `chem_max_iter` cuts the fixed point short (the control only:
        # in bfloat16 its 1% test is never met, and the iterate sits at
        # the precision's noise floor once the damping has begun)
        chem = dict(isothermal=self.isothermal, cooling=self.cooling,
                    isothermal_temperature=self.t0)
        if chem_max_iter is not None:
            chem["max_iter"] = int(chem_max_iter)
        self.chem = ChemistryConfig(**chem)

    def _t(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- the driver's scalars ----------------------------------------------
    def steps(self, num_slices: int) -> list:
        """Per step of a cycle from the initial state: the slice, z1, its
        dt, the proper cell size, the density factor since the slice's
        file was read, the cooling factor and the LLS column per cell,
        as Run3D's clock and cosmo_evol give them (C2Ray.F90:238-380).
        A run that is not cosmological keeps the comoving cell size, the
        density as read and the first LLS column, and cools by no
        expansion (c2ray_parameters.f90:84)."""
        zs = self.nbody.zred_array
        clock = CosmoClock.init(self.cosmo, float(zs[0]))
        dr = self.dr_comoving
        if self.cosmological:
            clock, zf0, _ = clock.redshift_evol(0.0)
            dr *= zf0
        lls = LLSModel(type_of_LLS=self.lls_type).initialised(
            float(zs[0]), dr, self.cosmo)
        out = []
        for nz in range(num_slices):
            z1, z2 = float(zs[nz]), float(zs[nz + 1])
            t1 = clock.zred2time(z1)
            dt = (clock.zred2time(z2) - t1) / self.steps_per_slice
            factor = 1.0
            for step in range(self.steps_per_slice):
                clock, zf, _ = clock.redshift_evol(t1 + (step + 0.5) * dt)
                if self.cosmological and zf != 1.0:
                    factor /= zf**3
                    lls = lls.evolve(zf)
                    dr *= zf
                col = lls.coldensh_per_cell()
                out.append(dict(
                    slice=nz, z1=z1, dt=float(dt), dr=float(dr),
                    ndens_factor=factor,
                    ccf=None if self.isothermal or not self.cosmological
                    else clock.cosmo_cool_factor(),
                    lls=float(col) if float(col) > 0.0 else None))
        return out

    # -- inputs ------------------------------------------------------------
    def initial_state(self, step0: dict) -> GridState:
        """The state Run3D hands its first evolve3d call: the slice's
        density (proper, rescaled to the step's mid-point), fractions
        from the restart cubes or neutral, the initial temperature."""
        M = self.mesh
        z1 = step0["z1"]
        nd = read_density_file(self.nbody, z1, M,
                               density_unit=self.run3d.get("density_unit",
                                                           "grid"))
        nd = nd * step0["ndens_factor"]
        xh1 = xhe1 = xhe2 = 0.0
        restart = self.restart_z
        if restart is not None:
            base = self.run3d["results_dir"]
            zs = _zred_str(restart)
            cube = lambda stem: read_unformatted_cube(
                os.path.join(base, f"{stem}_{zs}.bin"), dtype=np.float64)
            xh1, xhe1, xhe2 = protect_ionization_fractions(
                cube("xfrac3d"), cube("xfrac3dHe1"), cube("xfrac3dHe2"))
        return initial_grid_state(nd, xh1, xhe1, xhe2, self.t0,
                                  clumping=1.0, dtype=self.dtype,
                                  device=self.device)

    def sources(self, step: dict, h1) -> tuple:
        """(srcpos (S, 3) int64, nflux (S, 3)) of the step's slice: the
        halo catalog with suppression against the ionized fraction `h1`
        and the Iliev et al. luminosities (source_properties)."""
        cat = read_halo_catalog(self.nbody, step["z1"])
        h1 = torch.as_tensor(h1).to(torch.float64).cpu().numpy()
        src, _ = apply_suppression_and_luminosities(
            cat, h1, self.halo_model, self.sed, step["dt"],
            slice_index=step["slice"])
        return (torch.as_tensor(src.srcpos, dtype=torch.int64,
                                device=self.device),
                self._t(src.nflux))

    def total_source_rate(self, nflux) -> float:
        """Photons/s of all sources: each type's normalised fluxes times
        its S_star (Run3D._total_source_rate)."""
        total = 0.0
        for j, sq in enumerate((self.sed.bb, self.sed.pl, self.sed.qso)):
            if sq is not None:
                total += float(torch.sum(nflux[:, j].double())) * sq.S_star
        return total

    # -- the iteration -----------------------------------------------------
    def _sweep_cfg(self, step):
        return SweepConfig(tables=self.tables, mesh=self.mesh, dr=step["dr"],
                           isothermal=self.isothermal,
                           flux_scale=self.flux_scale,
                           has_bb=self.sed.bb is not None,
                           has_pl=self.sed.pl is not None,
                           has_qso=self.sed.qso is not None)

    def _lls_grid(self, step):
        if step["lls"] is None:
            return None
        return torch.full((self.mesh**3,), step["lls"], dtype=self.dtype,
                          device=self.device)

    def _trace(self, state, srcpos, nflux, radius, step):
        cfg = self._sweep_cfg(step)
        fields = SourceFields(*(self._t(getattr(state, n)) for n in
                                ("ndens", "h_av0", "h_av1", "he_av0",
                                 "he_av1")))
        fstack = stack_sweep_fields(cfg, fields)
        Rf, Rb = trace_extents(self.mesh, radius)
        vos = step["dr"] ** 3 / self.flux_scale
        return cfg, fstack, Rf, Rb, vos

    def source_slabs(self, state, srcpos, nflux, radius, step):
        """Per-source traces: yields (index, slab (M^3, 4), photon loss,
        LLS loss) for each source, the losses in photons/s.  `radius`
        cuts the pyramid sweep's extents; the shell sweep runs its
        table's."""
        cfg, fstack, Rf, Rb, vos = self._trace(state, srcpos, nflux, radius,
                                               step)
        lls = self._lls_grid(step)
        for g0 in range(0, srcpos.shape[0], GROUP):
            sp = srcpos[g0:g0 + GROUP].to(self.device)
            nf = self._t(nflux[g0:g0 + GROUP])
            if self.shells is not None:
                slab, pl, ll = shell_plain(cfg, self.shells, fstack, sp, nf,
                                           dr=step["dr"],
                                           vol_over_scale=vos, lls=lls)
            else:
                slab, pl, ll, _ = trace_plain(cfg, fstack, sp, nf, Rf, Rb,
                                              dr=step["dr"],
                                              vol_over_scale=vos, lls=lls)
            for i in range(sp.shape[0]):
                yield (g0 + i, slab[i], float(pl[i]) * self.flux_scale,
                       float(ll[i]) * self.flux_scale)

    def sweep(self, state, srcpos, nflux, radius, step) -> RateGrids:
        """The summed rate grids and losses of all sources (in source
        order), the losses in photons/s."""
        rg = torch.zeros((self.mesh**3, 4), dtype=self.dtype,
                         device=self.device)
        pl = ll = 0.0
        for i, slab, p, l in self.source_slabs(state, srcpos, nflux, radius,
                                               step):
            if bool(torch.any(nflux[i] > 0.0)):
                rg += slab
                pl += p
                ll += l
        # the losses stay float64: photons/s overflow a lower precision
        f64 = lambda x: torch.tensor(x, dtype=torch.float64)
        return RateGrids(rg[:, 0], rg[:, 1], rg[:, 2], rg[:, 3], f64(pl),
                         f64(ll))

    def chemistry(self, state, rates, step) -> GridState:
        """One chemistry pass over the whole grid."""
        st = GridState(*(self._t(x) for x in state))
        rt = RateGrids(*(None if x is None else self._t(x) for x in rates))
        new, _, _, _ = chemistry_pass_plain(self.chem, st, rt, step["dt"],
                                            step["ccf"])
        return new

    @staticmethod
    def begin(state) -> GridState:
        return begin_timestep(state)

    @staticmethod
    def finish(state) -> GridState:
        return finish_timestep(state)

    # -- the photon budget -------------------------------------------------
    def budget(self, state_in, state_out, step, total_src, photon_loss,
               lls_loss):
        """The step's photon budget (photonstatistics), from the state
        the step started from and the one it ended in; the losses in
        photons/s."""
        st_in = GridState(*(self._t(x) for x in state_in))
        st_out = GridState(*(self._t(x) for x in state_out))
        vol = step["dr"] ** 3
        before = species_inventory(st_in, vol)
        temp = (self._t(self.t0) if self.isothermal else st_out.t_av)
        return photon_budget(before, st_out, rate_coefficients(temp), vol,
                             step["dt"], total_src, photon_loss=photon_loss,
                             lls_loss=lls_loss)
