"""Declarative run configuration with dict/JSON loading.

Port of ``c2ray_tpu/config.py``: the reference's three-tier config
(compile-time modules, cpp flags, positional stdin decks; SURVEY.md
section 5 'Config') collapses into `driver.Run3DConfig`, and this module
adds a single plain-data entry point so a whole run is one JSON file
(the replacement for `inputs/input_example*` decks,
files_for_3D/C2Ray.F90:110-121).  ``dtype`` may be given by name
("float32", "float64").  `oned_problem_from_dict` builds the 1D
program's problem.
"""

import json
from dataclasses import fields as dc_fields

from .cosmology import COSMOLOGIES, DEFAULT_COSMOLOGY
from .driver import Run3DConfig
from .io.writers import OutputStreams
from .material import ClumpingModel, LLSModel
from .nbody import (cubep3m_nbody, gadget_nbody, pmfast_nbody, test4_nbody,
                    test_nbody)
from .onedim.material import OneDProblem
from .radiation.sed import BlackBodySED, PowerLawSED, SEDConfig

_NBODY_FACTORIES = {
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


def sed_config_from_dict(d: dict) -> SEDConfig:
    bb = BlackBodySED(**d["bb"]) if "bb" in d else None
    pl = PowerLawSED(**d["pl"]) if "pl" in d else None
    qso = PowerLawSED(**d["qso"]) if "qso" in d else None
    return SEDConfig(bb=bb, pl=pl, qso=qso)


def run3d_config_from_dict(d: dict) -> Run3DConfig:
    """Build a Run3DConfig from plain data.

    Expected keys: mesh, sed{bb{...}}, nbody{type, ...},
    optional cosmology (name from COSMOLOGIES), clumping{...},
    lls{...}, streams{...} and any scalar Run3DConfig field (among
    them device and dtype).
    """
    d = dict(d)
    cosmo = COSMOLOGIES.get(d.pop("cosmology", "WMAP3plus"),
                            DEFAULT_COSMOLOGY)
    nb_spec = dict(d.pop("nbody"))
    nb_type = nb_spec.pop("type")
    nbody = _NBODY_FACTORIES[nb_type](nb_spec, cosmo)
    sed = sed_config_from_dict(d.pop("sed"))
    clumping = ClumpingModel(**d.pop("clumping", {}))
    lls = LLSModel(**d.pop("lls", {}))
    streams = OutputStreams(**d.pop("streams", {}))
    halo_model = None
    if "halo_model" in d:
        from .sources import HaloSourceModel

        hm = dict(d.pop("halo_model"))
        # the halo mass unit defaults to the nbody backend's grid mass
        # (M_grid, cubep3m.F90:119-132)
        if hm.get("M_grid", "auto") == "auto":
            hm["M_grid"] = nbody.M_grid
        if "phot_per_atom" in hm:
            hm["phot_per_atom"] = tuple(hm["phot_per_atom"])
        hm.setdefault("Omega_B", cosmo.Omega_B)
        hm.setdefault("Omega0", cosmo.Omega0)
        halo_model = HaloSourceModel(**hm)

    valid = {f.name for f in dc_fields(Run3DConfig)}
    extra = set(d) - valid
    if extra:
        raise ValueError(f"unknown Run3DConfig keys: {sorted(extra)}")
    return Run3DConfig(nbody=nbody, sed=sed, clumping=clumping, lls=lls,
                       streams=streams, halo_model=halo_model, **d)


def run3d_config_from_json(path: str) -> Run3DConfig:
    with open(path) as f:
        return run3d_config_from_dict(json.load(f))


def oned_problem_from_dict(d: dict) -> OneDProblem:
    """A 1D problem from plain data: OneDProblem's fields, the cosmology
    by name (COSMOLOGIES) and gamma_uvb as a list."""
    d = dict(d)
    cosmo = COSMOLOGIES.get(d.pop("cosmology", "WMAP3plus"),
                            DEFAULT_COSMOLOGY)
    gamma = tuple(d.pop("gamma_uvb", (0.0, 0.0, 0.0)))
    return OneDProblem(cosmology=cosmo, gamma_uvb=gamma, **d)
