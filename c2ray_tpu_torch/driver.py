"""3D main driver: the redshift-slice loop.

Port of ``c2ray_tpu/driver.py`` (``code/files_for_3D/C2Ray.F90``, program
C2Ray, and the 3D times module ``code/time_ini.F90``).  The reference's
stdin deck and compile-time constants collapse into one
:class:`Run3DConfig`; the init sequence (C2Ray.F90:103-235) is
`Run3D.__init__`, the redshift loop (C2Ray.F90:238-380) `Run3D.run`.

Tables, state and sources live on ``Run3DConfig.device``: the card
("cuda", the default, which the kernels need) or, when asked for, the
CPU, where the sweep and chemistry run their plain versions.  Files,
halo catalogs and the suppression test are host numpy (the ionization
grid is copied to the host once per slice for it).
"""

import os
import time as _time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .cooling import setup_cooling_tables
from .cosmology import CosmoClock
from .grid import CartesianGrid
from .io.writers import OutputStreams, OutputWriter
from .material import ClumpingModel, LLSModel, uniform_density_grid
from .nbody import NBodyInterface
from .photonstats import (photcons_violation, photon_budget,
                          species_inventory)
from .radiation.quadrature import build_quadrature_tables
from .radiation.sed import SEDConfig
from .rates import rate_coefficients
from .sources import SourceList
from .state import GridState, initial_grid_state
from .sweep import Evolve3DConfig, SweepConfig, build_shell_table, evolve3d
from .sweep.global_pass import ChemistryConfig

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def set_timesteps(clock: CosmoClock, z1, z2, n_steps: int):
    """Convert a redshift interval to an even timestep
    (set_timesteps, time_ini.F90:70-96)."""
    t1 = clock.zred2time(z1)
    t2 = clock.zred2time(z2)
    dt = (t2 - t1) / n_steps
    return float(t1), float(t2), float(dt)


@dataclass
class Run3DConfig:
    """Declarative configuration replacing the reference's stdin deck +
    compile-time parameter modules (SURVEY.md section 5 'Config')."""

    mesh: int
    nbody: NBodyInterface
    sed: SEDConfig
    isothermal: bool = True
    initial_temperature: float = 1.0e4
    steps_per_slice: int = 2          # time_ini.F90:44-61
    outputs_per_slice: int = 1
    clumping: ClumpingModel = field(default_factory=ClumpingModel)
    lls: LLSModel = field(default_factory=LLSModel)
    cosmological: bool = True         # c2ray_parameters.f90:84
    results_dir: str = "./results/"
    dump_dir: str = "./"
    streams: OutputStreams = field(default_factory=OutputStreams)
    # torch.float64 / torch.float32 (or their names); the card runs
    # float32, the tests float64
    dtype: object = torch.float64
    # trace extent cap (c2ray_parameters.f90:52-56): below M/2 - 1, and
    # at an odd mesh, the timestep runs the L1-shell engine
    max_subbox: Optional[int] = None
    # iteration-dump cadence in wall-clock seconds (evolve.F90:205-208)
    dump_interval_s: float = 15 * 60.0
    # abort the run on a photon-conservation violation
    # (c2ray_parameters.f90:81, C2Ray.F90:351-372); the tolerance is
    # the reference's (commented) 15% criterion (output.F90:522-533)
    stop_on_photon_violation: bool = False
    photcons_tolerance: float = 0.15
    # --- per-slice input plumbing for Run3D.run() (C2Ray.F90:238-380)
    # "uniform": synthetic dens_ini; "files": read <z>n_all.dat per
    # slice (dens_ini, mat_ini_cubep3m.F90:223-351)
    density_input: str = "uniform"
    density_unit: str = "grid"        # grid | particle | M0Mpc3
    # "model": the ClumpingModel/LLSModel above; "files": read
    # per-slice grids (mat_ini_cubep3m.F90:460-520, 667-763)
    clumping_input: str = "model"
    lls_input: str = "model"
    # "static": the SourceList passed to run(); "catalog": read halo
    # catalogs per slice and apply suppression against the current
    # ionization state (source_properties, sourceprops_cubep3m.F90:
    # 251-413); "file": re-read a test_sources.dat each slice
    source_input: str = "static"
    halo_model: Optional[object] = None   # sources.HaloSourceModel
    source_file: Optional[str] = None
    # randomize source order per slice (ctrper, sourceprops_test.F90:
    # 205-210) -- order only matters for float reduction noise here
    randomize_sources: bool = False
    # --- multi-GPU execution (parallel/): None, one device; "source":
    # source-parallel over a replicated grid (the reference's MPI
    # model); "domain": the grid cut into x-slabs over the ranks.  Both
    # run SPMD, one process per device, in an initialised default
    # process group (torchrun, or parallel.launch) of n_devices ranks
    # (None: any size); `balance_halo` E > 0 spreads the domain mode's
    # sources over the ranks with E extra halo planes
    parallel: Optional[str] = None
    n_devices: Optional[int] = None
    balance_halo: int = 0
    # where tables, state and sources live: "cuda" (the kernels) or,
    # when asked for, "cpu" (the plain versions)
    device: str = "cuda"


class PhotonConservationError(RuntimeError):
    """Raised by Run3D when photon conservation is violated and
    stop_on_photon_violation is set (C2Ray.F90:351-372)."""


def _device_of(name) -> torch.device:
    """The configured device (Run3DConfig.device, OneDRun.setup's
    device); a CUDA device when CUDA is absent raises (the run never
    drops to the CPU on its own).  Under an initialised process group,
    "cuda" is the rank's own card, cuda:<local rank>."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} but CUDA is not available; pass "
            f"device='cpu' to run the plain versions on the CPU")
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None else
                           dist.get_rank() % torch.cuda.device_count())
    return dev


def shared_seed(device) -> int:
    """A random seed drawn on rank 0 and broadcast to every rank of the
    default process group."""
    seed = torch.tensor([np.random.SeedSequence().entropy % 2**62],
                        dtype=torch.int64, device=device)
    dist.broadcast(seed, src=0)
    return int(seed)


def _parallel_config(c, evolve_cfg, device):
    """The ParallelConfig of the default process group for
    Run3DConfig.parallel; raises without a group of the configured
    size, and when the group's backend does not take `device`."""
    from .parallel import ParallelConfig, comm

    if c.parallel not in ("source", "domain"):
        raise ValueError(f"parallel={c.parallel!r}: one of None, 'source', "
                         f"'domain'")
    if not dist.is_initialized():
        raise RuntimeError(
            f"parallel={c.parallel!r} runs one process per device in an "
            f"initialised torch.distributed process group (torchrun, or "
            f"c2ray_tpu_torch.parallel.launch); none is initialised")
    world = dist.get_world_size()
    if c.n_devices is not None and c.n_devices != world:
        raise ValueError(f"n_devices={c.n_devices} but the process group "
                         f"has {world} ranks")
    comm.check_device(torch.empty(0, device=device))
    return ParallelConfig(cfg=evolve_cfg)


class Run3D:
    """A configured 3D simulation."""

    def __init__(self, config: Run3DConfig):
        c = config
        config.dtype = _DTYPES.get(c.dtype, c.dtype)
        self.device = _device_of(c.device)
        self.config = config
        self.grid = CartesianGrid(boxsize_mpc_h=c.nbody.boxsize,
                                  mesh=(c.mesh,) * 3,
                                  h=c.nbody.cosmology.h)

        # rad_ini (C2Ray.F90:136)
        self.tables, self.sed, self.bands = build_quadrature_tables(
            c.sed, isothermal=c.isothermal, dtype=c.dtype, device=self.device)
        cooling = None if c.isothermal else setup_cooling_tables(
            c.dtype, self.device)

        self.clock = CosmoClock.init(c.nbody.cosmology,
                                     float(c.nbody.zred_array[0]))
        self.zfactor_total = 1.0
        # cosmology_init's immediate redshift_evol + cosmo_evol at t=0
        # (cosmology.f90:64-71): lengths go comoving -> proper at z0
        # once, here; densities are set per slice in proper units
        # (dens_ini, mat_ini_test.F90:210-265), so the per-step
        # rescales in _cosmo_evolve_to stay purely incremental.
        dr_proper = self.grid.dr
        if c.cosmological:
            self.clock, zf0, _ = self.clock.redshift_evol(0.0)
            dr_proper = self.grid.dr * zf0
        self.dr_proper = dr_proper
        self.lls = c.lls.initialised(float(c.nbody.zred_array[0]),
                                     dr_proper, c.nbody.cosmology)

        # position-dependent LLS (type 2) rides the sweep's per-cell
        # LLS channel; a type-1 scalar in a cosmological run also goes
        # through the per-cell grid because it evolves with z
        # (cosmo_evol, cosmology.f90:199-201) -- only a static scalar
        # is baked into the config
        lls_col = self.lls.coldensh_per_cell()
        self.lls_grid = None
        lls_static = 0.0
        if not np.isscalar(lls_col):
            self.lls_grid = self._on_device(np.asarray(lls_col).reshape(-1))
        elif float(lls_col) > 0.0 and c.cosmological:
            pass   # a grid per step in run_slice
        else:
            lls_static = float(lls_col)
        sweep_cfg = SweepConfig(
            tables=self.tables, mesh=c.mesh, dr=dr_proper,
            isothermal=c.isothermal, flux_scale=self.bands.flux_scale,
            coldensh_LLS=lls_static,
            has_bb=c.sed.bb is not None, has_pl=c.sed.pl is not None,
            has_qso=c.sed.qso is not None)
        # cosmological adiabatic cooling is a per-step input (run_slice
        # passes 2(dz/dt)/(1+z) into evolve3d), not a config constant
        chem_cfg = ChemistryConfig(
            cooling=cooling, isothermal=c.isothermal,
            isothermal_temperature=c.initial_temperature)
        # the shell engine's extents; the full periodic ones (even mesh,
        # no cap below M/2 - 1) keep the pyramid engine
        shells = build_shell_table(c.mesh, c.max_subbox)
        self.evolve_cfg = Evolve3DConfig(sweep=sweep_cfg, chem=chem_cfg,
                                         shells=shells)
        # multi-device execution: every rank holds the whole state
        # between steps (the domain mode cuts it into slabs for the
        # timestep); only rank 0 writes files
        self.pconfig = (None if c.parallel is None else
                        _parallel_config(c, self.evolve_cfg, self.device))
        self.is_writer = self.pconfig is None or dist.get_rank() == 0

        # kept for the JAX driver's call of evolve3d, which ignores it:
        # nothing is compiled per subbox radius
        self._iteration_cache = {}
        self._subbox_radius: Optional[int] = None
        self.writer = OutputWriter(c.results_dir, c.streams,
                                   isothermal=c.isothermal)
        self.state: Optional[GridState] = None
        self.time = 0.0
        self._last_dump = _time.time()
        self.photcons_flag = 0
        self.last_budget = None
        self.last_suppression = None

    def _on_device(self, a):
        return torch.as_tensor(a, dtype=self.config.dtype, device=self.device)

    def _grid_state(self, ndens, xh1, xhe1, xhe2, temperature, clumping=1.0):
        return initial_grid_state(ndens, xh1, xhe1, xhe2, temperature,
                                  clumping=clumping, dtype=self.config.dtype,
                                  device=self.device)

    # -- material ----------------------------------------------------------
    def init_uniform_material(self, z=None):
        """mat_ini + dens_ini for the synthetic test backend
        (mat_ini_test.F90:83-265).  Density is set per slice in `run`."""
        c = self.config
        z = float(c.nbody.zred_array[0]) if z is None else z
        ndens = uniform_density_grid(c.mesh, z, c.nbody.cosmology)
        self.state = self._grid_state(ndens, 0.0, 0.0, 0.0,
                                      c.initial_temperature,
                                      clumping=c.clumping.at_redshift(z))

    def set_clumping(self, z):
        """set_clumping per slice (C2Ray.F90:270,
        mat_ini_test.F90:520-553): the redshift-fit models change with
        z; a type-5 grid is used per cell (chemistry broadcasts)."""
        cl = self.config.clumping.at_redshift(z)
        cl = self._on_device(np.asarray(cl, dtype=np.float64).reshape(-1)
                             if np.ndim(cl) else cl)
        self.state = self.state._replace(clumping=cl)

    def set_density(self, ndens):
        """dens_ini from an external (reader-supplied) cube."""
        c = self.config
        if self.state is None:
            self.state = self._grid_state(ndens, 0.0, 0.0, 0.0,
                                          c.initial_temperature)
        else:
            self.state = self.state._replace(
                ndens=self._on_device(np.asarray(ndens).reshape(-1)))

    # -- restart -----------------------------------------------------------
    def resume_from_iterdump(self):
        """Reload the most recent iteration dump (start_from_dump,
        evolve.F90:279-367)."""
        from .io.checkpoint import load_iterdump
        from .sweep.source_sweep import RateGrids

        niter, state_np, _ = load_iterdump(self.config.dump_dir, GridState,
                                           RateGrids)
        self.state = GridState(*(self._on_device(x)
                                 if np.asarray(x).dtype.kind == "f"
                                 else torch.as_tensor(x, device=self.device)
                                 for x in state_np))
        return niter

    def restart_from_slice(self, z):
        """Slice restart: read the ionization/temperature output cubes
        back as initial conditions (xfrac_ini/temper_ini,
        mat_ini_test.F90:269-465, C2Ray.F90:219-235)."""
        from .io import read_unformatted_cube
        from .io.writers import _zred_str
        from .material import protect_ionization_fractions

        c = self.config
        base = c.results_dir
        zs = _zred_str(z)
        xh1 = read_unformatted_cube(os.path.join(base, f"xfrac3d_{zs}.bin"),
                                    dtype=np.float64)
        xhe1 = read_unformatted_cube(
            os.path.join(base, f"xfrac3dHe1_{zs}.bin"), dtype=np.float64)
        xhe2 = read_unformatted_cube(
            os.path.join(base, f"xfrac3dHe2_{zs}.bin"), dtype=np.float64)
        xh1, xhe1, xhe2 = protect_ionization_fractions(xh1, xhe1, xhe2)
        temper = c.initial_temperature
        tpath = os.path.join(base, f"Temper3D_{zs}.bin")
        if not c.isothermal and os.path.exists(tpath):
            temper = read_unformatted_cube(tpath, dtype=np.float32)
        ndens = (self.state.ndens.cpu().numpy() if self.state is not None
                 else uniform_density_grid(c.mesh, z, c.nbody.cosmology))
        self.state = self._grid_state(ndens, xh1, xhe1, xhe2, temper)

    # -- cosmology ---------------------------------------------------------
    def _cosmo_evolve_to(self, t):
        """redshift_evol + cosmo_evol at mid-step (C2Ray.F90:322-325).

        Proper lengths/densities rescale; the grid dr and ndens change.
        """
        self.clock, zfactor, Hz = self.clock.redshift_evol(t)
        if not self.config.cosmological or zfactor == 1.0:
            return
        self.zfactor_total *= zfactor
        zf3 = zfactor**3
        self.state = self.state._replace(ndens=self.state.ndens / zf3)
        self.lls = self.lls.evolve(zfactor)
        # dr is an argument of every sweep, so the config stays as it
        # is (cosmo_evol, cosmology.f90:159-202, rescales in place)
        self.dr_proper *= zfactor

    # -- main loop ---------------------------------------------------------
    def run_slice(self, nz: int, sources: SourceList,
                  ndens: Optional[np.ndarray] = None,
                  write_output=True, start_from_dump=False):
        """Advance through redshift slice nz (C2Ray.F90:238-380).

        `start_from_dump` resumes the FIRST step mid-timestep from the
        newest iterdump (evolve.F90:279-367; C2Ray.F90:191-216)."""
        c = self.config
        zs = c.nbody.zred_array
        z1, z2 = float(zs[nz]), float(zs[nz + 1])
        t1, t2, dt = set_timesteps(self.clock, z1, z2, c.steps_per_slice)

        if ndens is not None:
            self.set_density(ndens)
        elif self.state is None:
            self.init_uniform_material(z1)
        self.set_clumping(z1)

        srcpos = torch.as_tensor(np.asarray(sources.srcpos),
                                 dtype=torch.int32, device=self.device)
        nflux = self._on_device(np.asarray(sources.nflux))

        stats_list = []
        for step in range(c.steps_per_slice):
            t_mid = t1 + (step + 0.5) * dt
            self._cosmo_evolve_to(t_mid)
            vol_now = float(self.dr_proper) ** 3
            before = species_inventory(self.state, vol_now)
            ccf = (self.clock.cosmo_cool_factor()
                   if (c.cosmological and not c.isothermal) else None)
            common = dict(
                dr=float(self.dr_proper), cosmo_cool_factor=ccf,
                iteration_cache=self._iteration_cache,
                initial_radius=self._subbox_radius,
                lls_grid=self._current_lls_grid(),
                # mid-iteration checkpoints on the reference's 15-min
                # wall clock (evolve.F90:199-212), in every mode
                dump_dir=c.dump_dir, dump_interval_s=c.dump_interval_s,
                start_from_dump=start_from_dump and step == 0)
            if c.parallel == "domain":
                from .parallel import (domain_evolve3d, gather_state_slabs,
                                       shard_state_slabs)

                slab, stats = domain_evolve3d(
                    self.pconfig, shard_state_slabs(self.state), srcpos,
                    nflux, dt, balance_halo=c.balance_halo, **common)
                self.state = gather_state_slabs(slab)
            elif c.parallel == "source":
                from .parallel import parallel_evolve3d

                self.state, stats = parallel_evolve3d(
                    self.pconfig, self.state, srcpos, nflux, dt, **common)
            else:
                self.state, stats = evolve3d(
                    self.evolve_cfg, self.state, srcpos, nflux, dt, **common)
            if stats.subbox_radius:
                self._subbox_radius = stats.subbox_radius
            self.time = t1 + (step + 1) * dt
            stats_list.append(stats)

            total_src = self._total_source_rate(sources) * dt
            # the budget's recombination/collision rates use the evolved
            # time-averaged temperature field, not the initial value
            # (photonstatistics.f90:150-203 re-runs
            # ini_rec_colion_factors per cell on temperature_grid slot 1)
            t_for_rates = (self._on_device(c.initial_temperature)
                           if c.isothermal else self.state.t_av)
            rates = rate_coefficients(t_for_rates)
            fs = self.bands.flux_scale
            budget = photon_budget(
                before, self.state, rates, vol_now, dt, total_src,
                photon_loss=stats.photon_loss * fs,
                lls_loss=stats.lls_loss * fs)
            self.last_budget = budget
            if self.is_writer:
                self.writer.write_photon_counts(budget)

            # photcons_flag + stop_on_photon_violation
            # (C2Ray.F90:351-372, output.F90:522-533)
            self.photcons_flag = photcons_violation(
                budget, c.photcons_tolerance)
            if self.photcons_flag and c.stop_on_photon_violation:
                raise PhotonConservationError(
                    f"photon conservation violated at z-slice {nz} "
                    f"step {step}: photcons="
                    f"{float(budget.photon_conservation):.4f}, "
                    f"loss fraction="
                    f"{(budget.total_photon_loss + budget.total_lls_loss) / max(budget.total_src, 1e-300):.4f}")

        if write_output and self.is_writer:
            self.write_output(z2, sources)
        return stats_list

    # -- full redshift loop -------------------------------------------------
    def slice_sources(self, nz: int, dt) -> SourceList:
        """source_properties for slice nz (C2Ray.F90:260): build the
        slice's source list from the configured input, applying
        suppression against the *current* ionization state."""
        from .io.readers import read_halo_catalog
        from .sources import (apply_suppression_and_luminosities,
                              randomize_source_order,
                              read_test_source_file)

        c = self.config
        z = float(c.nbody.zred_array[nz])
        if c.source_input == "catalog":
            if c.halo_model is None:
                raise ValueError("source_input='catalog' needs a "
                                 "halo_model (HaloSourceModel)")
            cat = read_halo_catalog(c.nbody, z)
            xh1 = (self.state.h1.cpu().numpy() if self.state is not None
                   else np.zeros(c.mesh**3))
            sources, sstats = apply_suppression_and_luminosities(
                cat, xh1, c.halo_model, self.sed, dt,
                slice_index=nz)
            self.last_suppression = sstats
        elif c.source_input == "file":
            sources = read_test_source_file(c.source_file, self.sed)
        else:
            raise ValueError(
                "source_input='static' runs need sources passed to "
                "run()/run_slice() directly")
        if c.randomize_sources:
            # every rank must trace from the same list: rank 0's seed
            sources = randomize_source_order(
                sources, rng=None if self.pconfig is None
                else shared_seed(self.device))
        return sources

    def prepare_slice(self, nz: int):
        """Per-slice material input (C2Ray.F90:260-271): dens_ini,
        set_clumping, set_LLS from files where configured."""
        from .io.readers import (read_clumping_file, read_density_file,
                                 read_lls_file)

        c = self.config
        z = float(c.nbody.zred_array[nz])
        if c.density_input == "files":
            nd = read_density_file(c.nbody, z, c.mesh,
                                   density_unit=c.density_unit)
            self.set_density(nd)
        elif self.state is None:
            self.init_uniform_material(z)
        if c.clumping_input == "files":
            c.clumping = ClumpingModel(
                type_of_clumping=5,
                grid=read_clumping_file(c.nbody, z))
        if c.lls_input == "files":
            self.lls = LLSModel(type_of_LLS=2,
                                grid=read_lls_file(c.nbody, z))
            self.lls_grid = self._on_device(
                np.asarray(self.lls.grid).reshape(-1))

    def run(self, sources: Optional[SourceList] = None, nz0: int = 0,
            num_slices: Optional[int] = None, write_output=True):
        """The full redshift loop (C2Ray.F90:238-380): for each slice,
        set the timestep, read/derive density + clumping + LLS, build
        the source list (suppression against the current xh), then run
        the timestep loop -- all from one declarative config.

        `sources`: a static SourceList for source_input='static' runs
        (the synthetic test configuration).  Stops early on a photon
        conservation violation when configured (C2Ray.F90:351-372).
        Returns the per-slice stats lists.
        """
        c = self.config
        zs = c.nbody.zred_array
        last = (len(zs) - 1 if num_slices is None
                else min(nz0 + num_slices, len(zs) - 1))
        all_stats = []
        for nz in range(nz0, last):
            self.prepare_slice(nz)
            z1, z2 = float(zs[nz]), float(zs[nz + 1])
            _, _, dt = set_timesteps(self.clock, z1, z2,
                                     c.steps_per_slice)
            slice_srcs = (sources if c.source_input == "static"
                          else self.slice_sources(nz, dt))
            if slice_srcs is None:
                raise ValueError("no sources: pass a SourceList or "
                                 "configure source_input")
            stats = self.run_slice(nz, slice_srcs,
                                   write_output=write_output)
            all_stats.append(stats)
        return all_stats

    def _current_lls_grid(self):
        """Per-cell LLS opacity column for this step, or None.

        Type-2 grids pass through; a type-1 scalar in a cosmological
        run is broadcast so its z-evolution reaches the sweep
        (set_LLS, mat_ini_test.F90:640-663)."""
        c = self.config
        if self.lls_grid is not None:
            return self.lls_grid
        col = self.lls.coldensh_per_cell()
        if np.isscalar(col) and float(col) > 0.0 and c.cosmological:
            return torch.full((c.mesh**3,), float(col), dtype=c.dtype,
                              device=self.device)
        return None

    def _total_source_rate(self, sources: SourceList):
        s = 0.0
        if self.sed.bb is not None:
            s += sources.nflux[:, 0].sum() * self.sed.bb.S_star
        if self.sed.pl is not None:
            s += sources.nflux[:, 1].sum() * self.sed.pl.S_star
        if self.sed.qso is not None:
            s += sources.nflux[:, 2].sum() * self.sed.qso.S_star
        return float(s)

    def write_output(self, z, sources: SourceList):
        M = self.config.mesh
        sh = (M, M, M)
        st = self.state
        host = lambda t: t.cpu().numpy().reshape(sh)
        xh = np.stack([host(st.h0), host(st.h1)], axis=-1)
        xhe = np.stack([host(st.he0), host(st.he1), host(st.he2)], axis=-1)
        ndens = host(st.ndens)
        temper = host(st.t_final)
        self.writer.write(z, xh=xh, xhe=xhe, ndens=ndens,
                          temperature=None if self.config.isothermal
                          else temper,
                          srcpos0=sources.srcpos[0]
                          if sources.n_sources else None)
        self.writer.write_mean_ionization(z, xh, xhe, ndens,
                                          self.evolve_cfg.sweep.vol)
