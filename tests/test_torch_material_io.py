"""The port's host modules against the JAX package's: material, nbody,
sources, io and utils.

These are numpy on both sides, so the results are compared exactly:
equal values, equal counts, and files equal byte for byte for equal
arrays.  Iteration dumps load across the packages in both directions.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import material as j_material
from c2ray_tpu import nbody as j_nbody
from c2ray_tpu import sources as j_sources
from c2ray_tpu.io import checkpoint as j_checkpoint
from c2ray_tpu.io import fortran_records as j_records
from c2ray_tpu.io import readers as j_readers
from c2ray_tpu.io import writers as j_writers
from c2ray_tpu.photonstats import PhotonBudget as JBudget
from c2ray_tpu.radiation import sed as j_sed
from c2ray_tpu.state import GridState as JGridState
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep.source_sweep import RateGrids as JRateGrids
from c2ray_tpu.utils import small as j_small
from c2ray_tpu_torch import convert, material, nbody, sources
from c2ray_tpu_torch.io import checkpoint, fortran_records, readers, writers
from c2ray_tpu_torch.photonstats import PhotonBudget
from c2ray_tpu_torch.radiation import sed
from c2ray_tpu_torch.state import GridState
from c2ray_tpu_torch.sweep import RateGrids
from c2ray_tpu_torch.utils import Clocks, memory_report, small

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)


def _same(a, b):
    """Equal values, leaf by leaf (numpy arrays, scalars, tuples)."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- material -------------------------------------------------------------

@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5])
def test_clumping_models_match_jax(kind):
    grid = np.random.RandomState(kind).uniform(1.0, 5.0, (4, 4, 4))
    kw = dict(type_of_clumping=kind, clumping_factor=2.5,
              grid=grid if kind == 5 else None)
    for z in (6.0, 9.0, 12.5):
        _same(material.ClumpingModel(**kw).at_redshift(z),
              j_material.ClumpingModel(**kw).at_redshift(z))


def test_lls_models_and_density_match_jax():
    from c2ray_tpu.cosmology import DEFAULT_COSMOLOGY as JC
    from c2ray_tpu_torch.cosmology import DEFAULT_COSMOLOGY as TC

    dr = 3.0e23
    for kind in (0, 1):
        t = material.LLSModel(type_of_LLS=kind).initialised(9.0, dr, TC)
        j = j_material.LLSModel(type_of_LLS=kind).initialised(9.0, dr, JC)
        assert t.n_LLS == j.n_LLS
        t, j = t.evolve(1.01), j.evolve(1.01)
        assert t.coldensh_per_cell() == j.coldensh_per_cell()
        assert t.mean_free_path_pMpc(dr) == j.mean_free_path_pMpc(dr)
    g = np.random.RandomState(0).uniform(0.0, 1e17, (4, 4, 4))
    _same(material.LLSModel(type_of_LLS=2, grid=g).coldensh_per_cell(),
          j_material.LLSModel(type_of_LLS=2, grid=g).coldensh_per_cell())
    assert material.mean_baryon_density(8.5, TC) == \
        j_material.mean_baryon_density(8.5, JC)
    _same(material.uniform_density_grid(4, 8.5, TC),
          j_material.uniform_density_grid(4, 8.5, JC))


def test_protect_fractions_and_compressed_codec_match_jax():
    rng = np.random.RandomState(1)
    x = [rng.uniform(-0.1, 1.2, 200) for _ in range(3)]
    _same(material.protect_ionization_fractions(*x),
          j_material.protect_ionization_fractions(*x))
    xh = np.concatenate([rng.uniform(0.0, 1.0, 200), [0.0, 0.5, 1.0]])
    a = material.compress_ionized_fraction(xh)
    _same(a, j_material.compress_ionized_fraction(xh))
    _same(material.ionized_from_compr(a), j_material.ionized_from_compr(a))
    _same(material.neutral_from_compr(a), j_material.neutral_from_compr(a))


# --- nbody -------------------------------------------------------------

def _zfile(tmp_path):
    p = tmp_path / "redshifts.dat"
    p.write_text("3\n9.000\n8.500\n8.000\n")
    return str(p)


def _backends(tmp_path, mod):
    z = _zfile(tmp_path)
    base = str(tmp_path) + "/"
    return [mod.test_nbody(), mod.test4_nbody(data_dir=base),
            mod.cubep3m_nbody(z, boxsize=10.0, n_box=64, base_dir=base,
                              source_dir=base),
            mod.pmfast_nbody(z, base_dir=base),
            mod.lg_nbody(z, 64.0, base_dir=base, id_str="LGtest"),
            mod.gadget_nbody(z, 20.0, base_dir=base)]


def test_nbody_backends_match_jax(tmp_path):
    for t, j in zip(_backends(tmp_path, nbody), _backends(tmp_path, j_nbody)):
        for f in ("nbody_type", "boxsize", "dir_dens", "dir_clump",
                  "dir_src", "dir_LLS", "n_box", "id_str", "num_zred",
                  "M_box", "M_grid", "M_particle", "lscale", "tscale"):
            _same(getattr(t, f), getattr(j, f))
        _same(t.zred_array, j.zred_array)
        assert t.cosmology.cosmo_id == j.cosmology.cosmo_id
        for mesh in (8, 16):
            assert t.density_convert_grid(mesh) == j.density_convert_grid(mesh)
            assert t.density_convert_particle(mesh) == \
                j.density_convert_particle(mesh)


# --- sources -------------------------------------------------------------

def _seds():
    kw = dict(bb=dict(T_eff=5e4, S_star=1e48), pl=dict(index=2.5, S_star=1e47),
              qso=dict(index=1.8, S_star=1e47))
    return (sed.SEDConfig(bb=sed.BlackBodySED(**kw["bb"]),
                          pl=sed.PowerLawSED(**kw["pl"]),
                          qso=sed.PowerLawSED(**kw["qso"])),
            j_sed.SEDConfig(bb=j_sed.BlackBodySED(**kw["bb"]),
                            pl=j_sed.PowerLawSED(**kw["pl"]),
                            qso=j_sed.PowerLawSED(**kw["qso"])))


def test_test_sources_match_jax(tmp_path):
    t_sed, j_sed_ = _seds()
    pos = np.array([[1, 2, 3], [4, 5, 6]])
    _same(sources.make_test_sources(pos, [1e48, 2e48], t_sed, [1e46, 0.0],
                                    [0.0, 3e46]),
          j_sources.make_test_sources(pos, [1e48, 2e48], j_sed_,
                                      [1e46, 0.0], [0.0, 3e46]))
    f = tmp_path / "test_sources.dat"
    f.write_text("2\n1 2 3 1e48 1e46 0\n8 8 8 3e48 0 2e46\n")
    _same(sources.read_test_source_file(str(f), t_sed),
          j_sources.read_test_source_file(str(f), j_sed_))


@pytest.mark.parametrize("uv_model", ["Iliev et al", "Fixed N_gamma",
                                      "Fixed Ndot_gamma"])
def test_suppression_and_luminosities_match_jax(uv_model):
    """Suppression counts, luminosities and the Fixed-N_gamma carry-over
    over three slices, on a grid whose cells are half ionized."""
    t_sed, j_sed_ = _seds()
    rng = np.random.RandomState(4)
    M, N = 8, 40
    pos = rng.randint(0, M, (N, 3)).astype(np.int32)
    hm = np.where(rng.rand(N) < 0.4, rng.uniform(1.0, 50.0, N), 0.0)
    lm = np.where(rng.rand(N) < 0.7, rng.uniform(0.5, 5.0, N), 0.0)
    qso = np.where(rng.rand(N) < 0.2, rng.uniform(1e40, 1e42, N), 0.0)
    xh1 = rng.uniform(0.0, 0.2, M**3)
    kw = dict(M_grid=1e38, uv_model=uv_model,
              uv_array=np.array([1e60, 2e60, 3e60]))
    tm, jm = sources.HaloSourceModel(**kw), j_sources.HaloSourceModel(**kw)
    tcat = sources.HaloCatalog(pos, hm, lm, qso)
    jcat = j_sources.HaloCatalog(pos, hm, lm, qso)
    for nz in range(3):
        for grid in (xh1, xh1.reshape(M, M, M)):
            t = sources.apply_suppression_and_luminosities(
                tcat, grid, tm, t_sed, 1e13, slice_index=nz)
            j = j_sources.apply_suppression_and_luminosities(
                jcat, grid, jm, j_sed_, 1e13, slice_index=nz)
            _same(t, j)
        assert tm.cumulative_uv == jm.cumulative_uv
    assert t[1].n_total == N and 0 < t[1].n_active < N
    if uv_model == "Iliev et al":
        assert t[1].n_suppressed > 0


def test_source_order_permutation_matches_jax():
    rng = np.random.RandomState(2)
    sl = (rng.randint(0, 16, (20, 3)).astype(np.int32), rng.rand(20, 3))
    _same(sources.controlled_permutation(20, 0.5, rng=7),
          j_sources.controlled_permutation(20, 0.5, rng=7))
    _same(sources.randomize_source_order(sources.SourceList(*sl), rng=3),
          j_sources.randomize_source_order(j_sources.SourceList(*sl), rng=3))


# --- io: writers byte for byte, readers round-trip -------------------------

def _fields(M=8, seed=3):
    rng = np.random.RandomState(seed)
    h1 = rng.uniform(0.0, 1.0, (M, M, M))
    he = rng.dirichlet((1.0, 1.0, 1.0), (M, M, M))
    return dict(xh=np.stack([1.0 - h1, h1], axis=-1), xhe=he,
                ndens=rng.uniform(1e-4, 1e-3, (M, M, M)),
                temperature=rng.uniform(1e2, 3e4, (M, M, M)),
                phih_grid=rng.uniform(0.0, 1e-12, M**3),
                phiheat_grid=rng.uniform(0.0, 1e-24, M**3),
                srcpos0=np.array([3, 4, 5]))


def test_writers_are_byte_identical(tmp_path):
    every = dict(axis_cut=True, ion_cubes=True, temper_rate_cubes=True,
                 midplane_cuts=True, density_cuts=True, compressed_ion=True)
    f = _fields()
    budget = (4.1e60, 5.2e60, 1.3e58, 2.2e59, 7.7e59, 3.3e57, 0.81, 2.2e59,
              6.6e59)
    for mod, name, B in ((writers, "port", PhotonBudget),
                         (j_writers, "jax", JBudget)):
        for iso in (True, False):
            w = mod.OutputWriter(str(tmp_path / f"{name}{iso}"),
                                 mod.OutputStreams(**every), isothermal=iso)
            for z in (8.9, 8.75):
                w.write(z, **f)
                w.write_mean_ionization(z, f["xh"], f["xhe"], f["ndens"],
                                        1e66)
                w.write_photon_counts(B(*budget[:6]))
                w.write_photon_counts(B(*budget[:6]), photon_loss=3e45,
                                      dt=1e13)
    for iso in (True, False):
        tdir, jdir = tmp_path / f"port{iso}", tmp_path / f"jax{iso}"
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(tdir)) and len(names) >= 14
        match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names,
                                                   shallow=False)
        assert mismatch == [] and errors == [], (mismatch, errors)


def test_fortran_records_and_readers_round_trip(tmp_path):
    rng = np.random.RandomState(8)
    cube = rng.rand(6, 6, 6).astype(np.float32)
    for markers, header in ((True, True), (False, False)):
        t_path, j_path = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
        fortran_records.write_unformatted_cube(t_path, cube, markers=markers,
                                               header=header)
        j_records.write_unformatted_cube(j_path, cube, markers=markers,
                                         header=header)
        assert filecmp.cmp(t_path, j_path, shallow=False)
        back = fortran_records.read_unformatted_cube(
            t_path, mesh=6, markers=markers, header=header)
        _same(back, cube)
        _same(back, j_records.read_unformatted_cube(
            j_path, mesh=6, markers=markers, header=header))

    # a cubep3m tree: density (three unit systems), clumping, LLS, halos
    z, M = 9.0, 6
    tn = nbody.cubep3m_nbody(_zfile(tmp_path), boxsize=10.0, n_box=64,
                             base_dir=str(tmp_path) + "/",
                             source_dir=str(tmp_path) + "/")
    jn = j_nbody.cubep3m_nbody(_zfile(tmp_path), boxsize=10.0, n_box=64,
                               base_dir=str(tmp_path) + "/",
                               source_dir=str(tmp_path) + "/")
    zs = readers._zred_str(z)
    for d in (tn.dir_dens, tn.dir_clump, tn.dir_LLS):
        os.makedirs(d, exist_ok=True)
    fortran_records.write_unformatted_cube(f"{tn.dir_dens}{zs}n_all.dat",
                                           cube)
    fortran_records.write_unformatted_cube(f"{tn.dir_clump}{zs}c_all.dat",
                                           cube + 1.0)
    fortran_records.write_unformatted_cube(f"{tn.dir_LLS}{zs}LLS.dat",
                                           cube * 1e17)
    (tmp_path / f"{zs}_wsubgrid_sources.dat").write_text(
        "3\n1 2 3 5.0 0.0 0.0\n6 6 6 0.0 2.0 0.0\n2 2 2 1.0 1.0 3e41\n")
    for unit in ("grid", "particle", "M0Mpc3"):
        t = readers.read_density_file(tn, z, M, density_unit=unit)
        _same(t, j_readers.read_density_file(jn, z, M, density_unit=unit))
        if unit == "grid":
            _same(t, cube.astype(np.float64) * tn.density_convert_grid(M)
                  * (1.0 + z) ** 3)
    _same(readers.read_clumping_file(tn, z),
          j_readers.read_clumping_file(jn, z))
    _same(readers.read_lls_file(tn, z), j_readers.read_lls_file(jn, z))
    cat = readers.read_halo_catalog(tn, z, n_extra_cols=1)
    _same(tuple(cat), tuple(j_readers.read_halo_catalog(jn, z,
                                                        n_extra_cols=1)))
    _same(cat.pos[1], [5, 5, 5])

    # compressed ionization cube written by the port, read by both
    xh = rng.uniform(0.0, 1.0, (M, M, M))
    path = str(tmp_path / "xh_compr.bin")
    fortran_records.write_unformatted_cube(
        path, material.compress_ionized_fraction(xh), dtype=np.float64)
    _same(readers.read_compressed_ion_cube(path),
          j_readers.read_compressed_ion_cube(path))
    np.testing.assert_allclose(readers.read_compressed_ion_cube(path), xh,
                               rtol=0.0, atol=1e-15)


def test_lg_density_reader_matches_jax(tmp_path):
    mesh, z, nz = 6, 8.0, 3
    zfile = _zfile(tmp_path)
    tn = nbody.lg_nbody(zfile, 64.0, base_dir=str(tmp_path) + "/",
                        id_str="LGtest")
    jn = j_nbody.lg_nbody(zfile, 64.0, base_dir=str(tmp_path) + "/",
                          id_str="LGtest")
    cube = np.random.RandomState(5).uniform(1e8, 1e10, (mesh,) * 3)
    cube[0, 0, 0] = 0.0
    with open(tmp_path / f"{nz:03d}rho_LGtest.dat", "wb") as f:
        fortran_records.write_fortran_record(
            f, np.asarray([mesh] * 3, dtype=np.int32))
        for k in range(mesh):
            fortran_records.write_fortran_record(
                f, cube[:, :, k].astype(np.float32))
    _same(readers.read_lg_density_file(tn, z, nz, mesh),
          j_readers.read_lg_density_file(jn, z, nz, mesh))


def test_source_list_files_are_byte_identical(tmp_path):
    rng = np.random.RandomState(9)
    sl = (rng.randint(0, 16, (5, 3)).astype(np.int32), rng.rand(5, 3))
    checkpoint.save_source_list(str(tmp_path / "t.dat"),
                                sources.SourceList(*sl))
    j_checkpoint.save_source_list(str(tmp_path / "j.dat"),
                                  j_sources.SourceList(*sl))
    assert filecmp.cmp(tmp_path / "t.dat", tmp_path / "j.dat", shallow=False)
    _same(checkpoint.load_source_list(str(tmp_path / "j.dat")),
          j_checkpoint.load_source_list(str(tmp_path / "t.dat")))


def test_iteration_dumps_load_across_packages(tmp_path):
    """A dump written by JAX loads in the port and one written by the
    port (tensors) loads in JAX, with equal leaves and metadata."""
    M = 4
    rng = np.random.RandomState(6)
    js = j_state(rng.uniform(1e-4, 1e-3, M**3), rng.uniform(0, 1, M**3),
                 0.1, 0.05, 1e4, clumping=2.0, dtype=jnp.float64)
    r = lambda: rng.uniform(0.0, 1e-12, M**3)
    jr = JRateGrids(jnp.asarray(r()), jnp.asarray(r()), jnp.asarray(r()),
                    jnp.asarray(r()), jnp.asarray(3e40), jnp.asarray(2e38),
                    jnp.asarray(rng.rand(47)))
    j_checkpoint.save_iterdump(str(tmp_path / "j"), 7, js, jr,
                               subbox_radius=8)
    n, st, rt, meta = checkpoint.load_iterdump(str(tmp_path / "j"), GridState,
                                               RateGrids, with_meta=True)
    assert (n, meta["subbox_radius"]) == (7, 8)
    _same(tuple(st), tuple(np.asarray(x) for x in js))
    _same(tuple(rt), tuple(np.asarray(x) for x in jr))

    ts = convert.grid_state_from_numpy(js)
    tr = convert.rate_grids_from_numpy(jr)._replace(photon_loss_bands=None)
    checkpoint.save_iterdump(str(tmp_path / "t"), 4, ts, tr, subbox_radius=16)
    n, st, rt, meta = j_checkpoint.load_iterdump(
        str(tmp_path / "t"), JGridState, JRateGrids, with_meta=True)
    assert (n, meta["subbox_radius"]) == (4, 16)
    assert rt.photon_loss_bands is None
    _same(tuple(st), tuple(t.numpy() for t in ts))
    _same(tuple(rt[:6]), tuple(t.numpy() for t in tr[:6]))


# --- utils -------------------------------------------------------------

def test_utils_match_jax(tmp_path):
    v = np.random.RandomState(1).randint(0, 5, 30)
    _same(small.mrgrnk(v), j_small.mrgrnk(v))
    for unit in ("cm", "kpc", "Mpc", " MPC ", "ly", "au"):
        assert small.parse_length(2.5, unit) == j_small.parse_length(2.5,
                                                                     unit)
    with pytest.raises(ValueError, match="unknown length unit"):
        small.parse_length(1.0, "furlong")
    clocks = Clocks(log_path=str(tmp_path / "Timings.log"))
    dw, dc = clocks.update("phase", sync=torch.zeros(1))
    assert dw >= 0.0 and dc >= 0.0
    wall, _ = clocks.report()
    assert wall >= dw
    log = (tmp_path / "Timings.log").read_text()
    assert "phase: wall=" in log and "# total wall=" in log
    line = memory_report()
    assert line.startswith("memory: ") and "VmRSS=" in line
