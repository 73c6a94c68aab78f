"""The Run3D driver's catalog-driven heating run and the iteration
dumps: the port against the JAX package, 16^3 float64.

The scenarios of tests/test_run_full.py and tests/test_iterdump.py,
with the helpers and tolerances of tests/test_torch_driver3d.py.  The
heating run keeps dt ~1.3e13 s, where the fixed point converges before
the damped regime and the thermal sub-cycle does not amplify the
packages' last-bit differences past rtol 1e-9.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep import build_shell_table
from c2ray_tpu.sweep.evolve3d import evolve3d as j_evolve3d
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.io.fortran_records import write_unformatted_cube
from c2ray_tpu_torch.io.readers import _zred_str
from c2ray_tpu_torch.sweep import evolve3d
from test_torch_driver3d import (M, _close_state, _runs, _same_outputs,
                                 _same_stats)

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)


def _cubep3m_tree(tmp_path, zreds):
    """A cubep3m-style input tree (tests/test_run_full.py:26-56):
    redshift list, per-slice density cubes in grid units and 2-halo
    catalogs (one massive, one suppressible low-mass halo)."""
    base = tmp_path / "nbody"
    dens_dir = base / "coarser_densities" / "halos_removed"
    src_dir = base / "sources"
    dens_dir.mkdir(parents=True)
    src_dir.mkdir(parents=True)
    zfile = base / "redshifts.txt"
    zfile.write_text(f"{len(zreds)}\n" + "\n".join(f"{z:.3f}" for z in zreds))
    rng = np.random.RandomState(11)
    for z in zreds:
        cube = 1.0 + 0.2 * rng.rand(M, M, M).astype(np.float32)
        cube[6:10, 6:10, 6:10] += 2.0
        write_unformatted_cube(str(dens_dir / f"{_zred_str(z)}n_all.dat"),
                               cube, dtype=np.float32)
        (src_dir / f"{_zred_str(z)}_wsubgrid_sources.dat").write_text(
            "2\n9 9 9 2000.0 0.0\n4 12 6 0.0 500.0\n")
    return str(zfile), str(base) + "/"


def test_heating_catalog_run_matches_jax(tmp_path):
    """Run3D.run() with heating on a cubep3m tree: density files, halo
    catalogs with suppression against the current ionization state,
    clumping, the cosmological cooling factor; slices 0.01 apart in z,
    so dt ~ 1.3e13 s."""
    zfile, base = _cubep3m_tree(tmp_path, [9.0, 8.99, 8.98])
    spec = {
        "mesh": M, "cosmology": "WMAP3plus",
        "nbody": {"type": "cubep3m", "redshift_file": zfile,
                  "boxsize": 0.7, "n_box": M, "base_dir": base,
                  "source_dir": base + "sources/"},
        "sed": {"bb": {"T_eff": 5.0e4, "S_star": 1.0e48}},
        "isothermal": False, "initial_temperature": 100.0,
        "steps_per_slice": 2, "density_input": "files",
        "source_input": "catalog",
        "halo_model": {"uv_model": "Iliev et al",
                       "phot_per_atom": [250.0, 250.0],
                       "lifetime": 1.0e13},
        "clumping": {"type_of_clumping": 1, "clumping_factor": 1.0},
        "streams": {"ion_cubes": True, "temper_rate_cubes": True},
    }
    jr, tr = _runs(tmp_path, spec, "heat")
    j_all = jr.run()
    t_all = tr.run()
    assert len(t_all) == 2
    for t_stats, j_stats in zip(t_all, j_all):
        _same_stats(t_stats, j_stats)
    assert tr.last_suppression == jr.last_suppression
    assert tr.last_suppression.n_total == 2
    _close_state(tr.state, jr.state)
    _same_outputs(jr.config.results_dir, tr.config.results_dir)
    T = tr.state.t_final.reshape(M, M, M).numpy()
    assert T[8, 8, 8] > 1.0e4 and np.isfinite(T).all()
    assert tr.last_budget.total_src > 0.0


def _evolve_setup():
    """tests/test_iterdump.py's setup in both packages."""
    from c2ray_tpu import constants as const
    from c2ray_tpu.radiation import BlackBodySED, SEDConfig
    from c2ray_tpu.radiation.quadrature import build_quadrature_tables
    from c2ray_tpu.sweep import SweepConfig as JSweepConfig
    from c2ray_tpu.sweep.evolve3d import Evolve3DConfig as JEvolveConfig
    from c2ray_tpu.sweep.global_pass import ChemistryConfig as JChemConfig
    from c2ray_tpu_torch.sweep import (ChemistryConfig, Evolve3DConfig,
                                       SweepConfig)

    tables, _, bands = build_quadrature_tables(
        SEDConfig(bb=BlackBodySED(T_eff=1.0e5, S_star=1.0e49)),
        isothermal=True, dtype=jnp.float64)
    kw = dict(mesh=M, dr=14.0 * const.kpc / M, isothermal=True,
              flux_scale=bands.flux_scale)
    jcfg = JEvolveConfig(
        sweep=JSweepConfig(tables=tables, **kw),
        chem=JChemConfig(cooling=None, isothermal=True),
        shells=build_shell_table(M))
    tcfg = Evolve3DConfig(
        sweep=SweepConfig(tables=convert.quad_tables_from_numpy(tables), **kw),
        chem=ChemistryConfig(isothermal=True))
    js = j_state(np.full((M, M, M), 1.0e-3), 0.0, 0.0, 0.0, 1.0e4)
    srcpos = np.array([[8, 8, 8], [4, 11, 6]])
    nflux = np.array([[1.0, 0.0, 0.0], [0.6, 0.0, 0.0]])
    return jcfg, tcfg, js, srcpos, nflux


def test_mid_iteration_dump_and_resume(tmp_path):
    """Dumps every iteration (dump_interval_s=0) leave the run as it
    was; dropping the newest dump and resuming re-enters the timestep
    one iteration back and reproduces the uninterrupted run
    (tests/test_iterdump.py:43-79), as JAX's resume does."""
    jcfg, tcfg, js, srcpos, nflux = _evolve_setup()
    dt = 5e13
    args = (convert.grid_state_from_numpy(js), torch.as_tensor(srcpos),
            torch.as_tensor(nflux), dt)
    ref, ref_stats = evolve3d(tcfg, *args)
    d = str(tmp_path / "port")
    s2, st2 = evolve3d(tcfg, *args, dump_dir=d, dump_interval_s=0.0)
    assert torch.equal(s2.h1, ref.h1) and st2 == ref_stats
    slots = [os.path.join(d, f"iterdump{s}.npz") for s in (1, 2)]
    assert all(os.path.exists(p) for p in slots)
    os.remove(max(slots, key=os.path.getmtime))
    s3, st3 = evolve3d(tcfg, *args, dump_dir=d, start_from_dump=True)
    assert st3.n_iterations == ref_stats.n_iterations
    for name in ("h1", "h_av1", "he1", "he2"):
        np.testing.assert_allclose(getattr(s3, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=1e-9,
                                   atol=1e-11, err_msg=name)
    # JAX resumes its own dump of the same run to the same state
    jd = str(tmp_path / "jax")
    jargs = (js, jnp.asarray(srcpos, jnp.int32), jnp.asarray(nflux), dt)
    j_evolve3d(jcfg, *jargs, dump_dir=jd, dump_interval_s=0.0)
    jslots = [os.path.join(jd, f"iterdump{s}.npz") for s in (1, 2)]
    os.remove(max(jslots, key=os.path.getmtime))
    j3, jst3 = j_evolve3d(jcfg, *jargs, dump_dir=jd, start_from_dump=True)
    assert (st3.n_iterations, st3.conv_flag, st3.subbox_radius) == (
        jst3.n_iterations, jst3.conv_flag, jst3.subbox_radius)
    _close_state(s3, j3)
