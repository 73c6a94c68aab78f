"""The Run3D driver: the port against the JAX package, 16^3 float64.

The scenarios of tests/test_driver3d.py run through both packages from
the same config (tests/test_torch_driver3d_run.py: the catalog-driven
heating run and the iteration dumps):
iteration counts, conv_flag and subbox radius agree exactly; state
fields to rtol 1e-9 with a 1e-11 absolute floor (the tolerance of
tests/test_torch_evolve3d.py); the text streams (PhotonCounts.out,
PhotonCounts2.out, Ifront1) are equal as text and the ionization cubes
to rtol 1e-9 (float32 cubes to 1 ulp).
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from c2ray_tpu import config as j_config
from c2ray_tpu import driver as j_driver
from c2ray_tpu.sources import SourceList as JSourceList
from c2ray_tpu_torch import config, driver
from c2ray_tpu_torch.io import read_unformatted_cube
from c2ray_tpu_torch.material import mean_baryon_density
from c2ray_tpu_torch.sources import SourceList

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16
SOURCES = (np.array([[8, 8, 8], [3, 11, 5]], dtype=np.int32),
           np.array([[1.0, 0.0, 0.0], [0.4, 0.0, 0.0]]))


def _runs(tmp_path, spec, name):
    """(JAX Run3D, port Run3D) of one config dict, each writing under
    tmp_path/<name>_{jax,port}."""
    out = []
    for pkg, mod, extra in (("jax", j_config, {}),
                            ("port", config, {"device": "cpu"})):
        d = dict(spec, results_dir=str(tmp_path / f"{name}_{pkg}") + "/",
                 dump_dir=str(tmp_path / f"{name}_{pkg}_dump") + "/",
                 **extra)
        cls = j_driver.Run3D if pkg == "jax" else driver.Run3D
        out.append(cls(mod.run3d_config_from_dict(d)))
    return out


def _close_state(t_state, j_state_):
    for name in t_state._fields:
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state_, name)),
                                   rtol=1e-9, atol=1e-11, err_msg=name)


def _same_stats(t_stats, j_stats):
    assert len(t_stats) == len(j_stats)
    for t, j in zip(t_stats, j_stats):
        assert (t.n_iterations, t.conv_flag, t.subbox_radius) == (
            j.n_iterations, j.conv_flag, j.subbox_radius)
        np.testing.assert_allclose(t.photon_loss, j.photon_loss, rtol=1e-9)
        np.testing.assert_allclose(t.lls_loss, j.lls_loss, rtol=1e-9)


def _same_outputs(jdir, tdir):
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for f in names:
        a, b = os.path.join(tdir, f), os.path.join(jdir, f)
        if f.startswith(("Temper3D", "IonRates3D", "HeatRates3D")):
            # float32 cubes: values within 1e-9 round at most 1 ulp apart
            np.testing.assert_allclose(read_unformatted_cube(a, np.float32),
                                       read_unformatted_cube(b, np.float32),
                                       rtol=2.0**-23, err_msg=f)
        elif f.endswith(".bin"):
            np.testing.assert_allclose(read_unformatted_cube(a, np.float64),
                                       read_unformatted_cube(b, np.float64),
                                       rtol=1e-9, atol=1e-11, err_msg=f)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), f


_SLICE = {
    "mesh": M, "nbody": {"type": "test"},
    "sed": {"bb": {"T_eff": 5.0e4, "S_star": 3e56}},
    "isothermal": True, "steps_per_slice": 2,
    "streams": {"ion_cubes": True, "axis_cut": True},
}


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """One slice of the synthetic test backend through both packages
    (tests/test_driver3d.py:27-70, two sources)."""
    tmp = tmp_path_factory.mktemp("slice")
    jr, tr = _runs(tmp, _SLICE, "slice")
    jr.init_uniform_material()
    tr.init_uniform_material()
    j_stats = jr.run_slice(0, JSourceList(*SOURCES))
    t_stats = tr.run_slice(0, SourceList(*SOURCES))
    return jr, tr, j_stats, t_stats


def test_set_timesteps_matches_jax():
    from c2ray_tpu.cosmology import CosmoClock as JClock
    from c2ray_tpu.nbody import test_nbody as j_test_nbody
    from c2ray_tpu_torch.cosmology import CosmoClock
    from c2ray_tpu_torch.nbody import test_nbody

    nb, jnb = test_nbody(), j_test_nbody()
    np.testing.assert_array_equal(nb.zred_array, jnb.zred_array)
    z0, z1 = float(nb.zred_array[0]), float(nb.zred_array[1])
    got = driver.set_timesteps(CosmoClock.init(nb.cosmology, z0), z0, z1, 4)
    ref = j_driver.set_timesteps(JClock.init(jnb.cosmology, z0), z0, z1, 4)
    assert got == ref


def test_run3d_slice_matches_jax(slice_runs):
    jr, tr, j_stats, t_stats = slice_runs
    _same_stats(t_stats, j_stats)
    assert all(s.n_iterations >= 2 for s in t_stats)
    _close_state(tr.state, jr.state)
    _same_outputs(jr.config.results_dir, tr.config.results_dir)
    h1 = tr.state.h1.reshape(M, M, M).numpy()
    assert h1[8, 8, 8] > 0.9 and h1.mean() > 1e-4
    lines = open(tr.config.results_dir + "PhotonCounts.out").readlines()
    assert len(lines) == 2
    assert tr.clock.zred == jr.clock.zred
    assert tr.dr_proper == jr.dr_proper
    assert tr.clock.zred < float(tr.config.nbody.zred_array[0])


def test_restart_from_slice_matches_jax(slice_runs):
    """Slice restart reads the output cubes back
    (mat_ini_test.F90:269-465): the port from its own cubes and from
    JAX's, both equal to JAX's restart."""
    jr, tr, _, _ = slice_runs
    z1 = float(jr.config.nbody.zred_array[1])
    j2 = j_driver.Run3D(replace(jr.config))
    j2.init_uniform_material(z1)
    j2.restart_from_slice(z1)
    for results in (tr.config.results_dir, jr.config.results_dir):
        t2 = driver.Run3D(replace(tr.config, results_dir=results))
        t2.init_uniform_material(z1)
        t2.restart_from_slice(z1)
        _close_state(t2.state, j2.state)
    np.testing.assert_allclose(t2.state.h1.numpy(), tr.state.h1.numpy(),
                               rtol=1e-12, atol=1e-15)


def test_config_from_dict_matches_jax(tmp_path):
    """One JSON blob configures a full 3D run in both packages."""
    spec = {"mesh": M, "nbody": {"type": "test"},
            "sed": {"bb": {"T_eff": 5.0e4, "S_star": 1e55}},
            "isothermal": True, "steps_per_slice": 1,
            "clumping": {"type_of_clumping": 1, "clumping_factor": 2.0},
            "dtype": "float64"}
    jr, tr = _runs(tmp_path, spec, "cfg")
    assert tr.config.mesh == M and tr.config.clumping.clumping_factor == 2.0
    assert tr.config.dtype == torch.float64 and tr.device.type == "cpu"
    src = (np.array([[8, 8, 8]], dtype=np.int32), np.array([[1., 0., 0.]]))
    jr.init_uniform_material()
    tr.init_uniform_material()
    j_stats = jr.run_slice(0, JSourceList(*src), write_output=False)
    t_stats = tr.run_slice(0, SourceList(*src), write_output=False)
    assert t_stats[0].n_iterations >= 2
    _same_stats(t_stats, j_stats)
    _close_state(tr.state, jr.state)
    with pytest.raises(ValueError, match="unknown Run3DConfig keys"):
        config.run3d_config_from_dict(dict(spec, nope=1))


def test_cosmological_density_stays_proper(tmp_path):
    """cosmology_init converts comoving->proper ONCE at t=0
    (tests/test_driver3d.py:120-153, on the port)."""
    _, tr = _runs(tmp_path, {"mesh": 8, "nbody": {"type": "test"},
                             "sed": {"bb": {"T_eff": 5e4, "S_star": 1e48}}},
                  "proper")
    nb = tr.config.nbody
    tr.init_uniform_material()
    z0 = float(nb.zred_array[0])
    np.testing.assert_allclose(float(tr.state.ndens[0]),
                               mean_baryon_density(z0, nb.cosmology),
                               rtol=1e-6)
    t1, t2, dt = driver.set_timesteps(tr.clock, z0, float(nb.zred_array[1]),
                                      tr.config.steps_per_slice)
    tr._cosmo_evolve_to(t1 + 0.5 * dt)
    z_mid = tr.clock.zred
    assert z_mid < z0
    np.testing.assert_allclose(float(tr.state.ndens[0]),
                               mean_baryon_density(z_mid, nb.cosmology),
                               rtol=1e-3)
    np.testing.assert_allclose(tr.dr_proper, tr.grid.dr / (1.0 + z_mid),
                               rtol=1e-3)


def test_lls_cosmological_run_matches_jax(tmp_path):
    """Type-1 LLS in a cosmological run: the z-evolving column goes
    through the sweep's per-cell LLS grid on every step."""
    spec = dict(_SLICE, lls={"type_of_LLS": 1},
                streams={"ion_cubes": True})
    jr, tr = _runs(tmp_path, spec, "lls")
    jr.init_uniform_material()
    tr.init_uniform_material()
    assert tr._current_lls_grid() is not None
    assert tr._current_lls_grid().shape == (M**3,)
    j_stats = jr.run_slice(0, JSourceList(*SOURCES))
    t_stats = tr.run_slice(0, SourceList(*SOURCES))
    assert all(s.lls_loss > 0.0 for s in t_stats)
    _same_stats(t_stats, j_stats)
    _close_state(tr.state, jr.state)
    _same_outputs(jr.config.results_dir, tr.config.results_dir)
    assert tr.lls.n_LLS == jr.lls.n_LLS


def test_run3d_default_device_needs_cuda(tmp_path):
    """No fallback: without CUDA, a Run3D on the default device raises
    instead of running on the CPU."""
    from c2ray_tpu_torch.nbody import test_nbody
    from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig

    cfg = driver.Run3DConfig(mesh=8, nbody=test_nbody(),
                             sed=SEDConfig(bb=BlackBodySED()),
                             results_dir=str(tmp_path / "r"))
    assert cfg.device == "cuda" and cfg.dtype == torch.float64
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.Run3D(cfg)
    # a parallel mode runs in a process group and never alone
    with pytest.raises(RuntimeError, match="process group"):
        driver.Run3D(replace(cfg, device="cpu", parallel="domain"))
