"""Chemistry: the port's plain versions against the JAX package.

float64 throughout.  The rate fits and one doric solve are elementwise
and agree to rtol 1e-12.  The chemistry pass iterates a fixed point in
which h0 = 1 - h1 cancels: fractions agree to rtol 1e-9 with a 1e-13
absolute floor (fractions are O(1)), and the iteration count and
conv_flag agree exactly.  The damped case sets DAMP_AFTER = 2 in both
packages so that the damped branch runs.

The heating pass adds the thermal sub-cycle, an explicit integration
whose step sequence amplifies last-bit differences between XLA's and
PyTorch's CPU math: after 140 sub-steps the two packages' temperatures
differ by ~3e-12, as much as a 1-ulp change of the input temperature
moves either package's own result, and the fixed point carries that on
into the fractions.  At time steps of 1e13-3e13 s (fixed points of
14-31 iterations) the fields agree to ~1e-11: they are held to rtol
1e-9 with a 1e-12 absolute floor, and conv_flag and the iteration count
agree exactly.  At 1e14 s the same inputs run the undamped iteration
past 50 rounds, where it amplifies those differences to 1e-8..1e-3;
such passes are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import c2ray_tpu.sweep.global_pass as j_gp
import c2ray_tpu_torch.sweep.global_pass as t_gp
from c2ray_tpu.chemistry import (IonFractions as JIF, IonState as JIS,
                                 doric as j_doric,
                                 prepare_doric_factors as j_factors)
from c2ray_tpu.cooling import setup_cooling_tables as j_cooling
from c2ray_tpu.rates import rate_coefficients as j_rc
from c2ray_tpu.state import initial_grid_state as j_state
from c2ray_tpu.sweep.source_sweep import RateGrids as JRG
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.chemistry import (IonFractions as TIF, IonState as TIS,
                                       doric as t_doric,
                                       prepare_doric_factors as t_factors)
from c2ray_tpu_torch.rates import rate_coefficients as t_rc
from c2ray_tpu_torch.sweep.source_sweep import RateGrids as TRG
from c2ray_tpu_torch.utils.clocks import counter

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

RTOL = 1e-12


def _close(a, b, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_rate_coefficients_match():
    T = np.logspace(1.0, 9.0, 500)
    a, b = t_rc(torch.as_tensor(T)), j_rc(jnp.asarray(T))
    for name in a._fields:
        # atol: XLA's CPU backend flushes denormals (colli_HI at 10 K)
        _close(getattr(a, name), getattr(b, name), atol=1e-300, msg=name)


def _ions(rng, n):
    def fr():
        h1 = rng.uniform(0.0, 1.0, n)
        he1 = rng.uniform(0.0, 0.6, n)
        he2 = rng.uniform(0.0, 0.4, n)
        return [1.0 - h1, h1, 1.0 - he1 - he2, he1, he2]
    return [fr(), fr(), fr()]


def test_doric_matches():
    rng = np.random.RandomState(3)
    n = 2000
    ions = _ions(rng, n)
    ndens = 10.0 ** rng.uniform(-5, 0, n)
    ne = ndens * rng.uniform(0.01, 1.1, n)
    ph = [10.0 ** rng.uniform(-20, -8, n) for _ in range(3)]
    T = 10.0 ** rng.uniform(3.5, 5.0, n)
    dt = 10.0 ** rng.uniform(10, 15, n)
    cols = [ndens * rng.uniform(0.0, 1.0, n) for _ in range(3)]

    jion = JIS(*(JIF(*map(jnp.asarray, f)) for f in ions))
    tion = TIS(*(TIF(*map(torch.as_tensor, f)) for f in ions))
    ja = j_doric(jnp.asarray(dt), jnp.asarray(ne), jion,
                 *map(jnp.asarray, ph),
                 j_factors(*map(jnp.asarray, cols)), j_rc(jnp.asarray(T)),
                 1.5, 1e-20)
    ta = t_doric(torch.as_tensor(dt), torch.as_tensor(ne), tion,
                 *map(torch.as_tensor, ph),
                 t_factors(*map(torch.as_tensor, cols)),
                 t_rc(torch.as_tensor(T)), 1.5, 1e-20)
    for part in ("cur", "avg"):
        for name in JIF._fields:
            _close(getattr(getattr(ta, part), name),
                   getattr(getattr(ja, part), name), rtol=1e-10, atol=1e-14,
                   msg=f"{part}.{name}")


def _pass_inputs(seed, n=512):
    """A random mid-timestep state and random rates (numpy)."""
    rng = np.random.RandomState(seed)
    ndens = 10.0 ** rng.uniform(-4, -1, n)
    h1 = rng.uniform(0.0, 0.9, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    phih = 10.0 ** rng.uniform(-16, -11, n)
    rates = [phih, phih * rng.uniform(0.1, 1, n), phih * 1e-3,
             np.zeros(n), 0.0, 0.0]
    return (ndens, h1, he1, he2), rates


def _run_both(seed, dt):
    fields, rates = _pass_inputs(seed)
    js = j_state(*fields, 1.0e4, dtype=jnp.float64)
    ts = convert.grid_state_from_numpy(js)
    jr = JRG(*[jnp.asarray(r) for r in rates])
    tr = TRG(*[torch.as_tensor(r, dtype=torch.float64) for r in rates])
    jcfg = j_gp.ChemistryConfig(cooling=None, isothermal=True)
    tcfg = t_gp.ChemistryConfig(isothermal=True)
    ion, t_inter, t_av, nit = j_gp._do_chemistry_global(
        jcfg, jnp.asarray(dt), js, jr.phih, jr.phihe0, jr.phihe1, jr.phiheat,
        host_loop=False)
    j_new, j_conv = j_gp._finalize_pass(js, ion, t_inter, t_av)
    t_new, t_conv, t_nit, t_sub = t_gp.chemistry_pass_plain(tcfg, ts, tr, dt)
    assert int(t_sub) == 0, "an isothermal pass runs no thermal sub-cycle"
    return (j_new, int(j_conv), int(nit)), (t_new, int(t_conv), int(t_nit))


def _check(j, t, rtol=1e-9, atol=1e-13):
    (j_new, j_conv, j_nit), (t_new, t_conv, t_nit) = j, t
    assert (t_conv, t_nit) == (j_conv, j_nit)
    for name in t_new._fields:
        _close(getattr(t_new, name), getattr(j_new, name), rtol=rtol,
               atol=atol, msg=name)
    return j_nit


@pytest.mark.parametrize("seed,dt", [(1, 1.0e13), (2, 3.0e15)])
def test_chemistry_pass_matches_in_graph_pass(seed, dt):
    _check(*_run_both(seed, dt))


def test_chemistry_pass_damped_matches(monkeypatch):
    monkeypatch.setattr(j_gp, "DAMP_AFTER", 2)
    monkeypatch.setattr(t_gp, "DAMP_AFTER", 2)
    nit = _check(*_run_both(4, 1.0e15))
    assert nit > 2, "the pass must reach the damped iterations"


def test_global_chemistry_pass_takes_the_plain_path_on_cpu():
    fields, rates = _pass_inputs(5, n=64)
    ts = convert.grid_state_from_numpy(j_state(*fields, 1.0e4,
                                               dtype=jnp.float64))
    tr = TRG(*[torch.as_tensor(r, dtype=torch.float64) for r in rates])
    tcfg = t_gp.ChemistryConfig(isothermal=True)
    before = counter("launches.chemistry")
    new, conv = t_gp.global_chemistry_pass(tcfg, ts, tr, 1.0e14)
    ref, ref_conv, _, _ = t_gp.chemistry_pass_plain(tcfg, ts, tr, 1.0e14)
    assert counter("launches.chemistry") == before
    assert int(conv) == int(ref_conv)
    for a, b in zip(new, ref):
        assert torch.equal(a, b)


def _heating_inputs(seed, n=256):
    """A random mid-timestep state with temperatures of 1e2-3e4 K and
    random rates including photo-heating (numpy)."""
    rng = np.random.RandomState(seed)
    ndens = 10.0 ** rng.uniform(-4, -1, n)
    h1 = rng.uniform(0.0, 0.9, n)
    he1 = rng.uniform(0.0, 0.5, n)
    he2 = rng.uniform(0.0, 0.3, n) * (1.0 - he1)
    T = 10.0 ** rng.uniform(2.0, 4.5, n)
    phih = 10.0 ** rng.uniform(-16, -11, n)
    # ~1-5 eV per photo-ionization of the cell's hydrogen
    heat = phih * ndens * 10.0 ** rng.uniform(-12.5, -11.5, n)
    rates = [phih, phih * rng.uniform(0.1, 1, n), phih * 1e-3, heat,
             0.0, 0.0]
    return (ndens, h1, he1, he2, T), rates


def _run_both_heating(seed, dt, ccf):
    fields, rates = _heating_inputs(seed)
    js = j_state(*fields, dtype=jnp.float64)
    ts = convert.grid_state_from_numpy(js)
    jr = JRG(*[jnp.asarray(r) for r in rates])
    tr = TRG(*[torch.as_tensor(r, dtype=torch.float64) for r in rates])
    cooling = j_cooling(jnp.float64)
    jcfg = j_gp.ChemistryConfig(cooling=cooling, isothermal=False)
    tcfg = t_gp.ChemistryConfig(
        isothermal=False, cooling=convert.cooling_tables_from_numpy(cooling))
    ion, t_inter, t_av, nit = j_gp._do_chemistry_global(
        jcfg, jnp.asarray(dt), js, jr.phih, jr.phihe0, jr.phihe1, jr.phiheat,
        ccf, host_loop=False)
    j_new, j_conv = j_gp._finalize_pass(js, ion, t_inter, t_av)
    t_new, t_conv, t_nit, t_sub = t_gp.chemistry_pass_plain(tcfg, ts, tr, dt,
                                                            ccf)
    assert int(t_sub) > 0
    # the pass really heats: temperatures move by more than 1%
    assert np.max(np.abs(np.asarray(t_av) / fields[4] - 1.0)) > 1e-2
    return (j_new, int(j_conv), int(nit)), (t_new, int(t_conv), int(t_nit))


@pytest.mark.parametrize("seed,dt,ccf,damped", [
    (1, 1.0e13, 0.0, False),
    (2, 3.0e13, 0.0, False),
    (6, 3.0e13, 1.0e-16, False),
    (4, 1.0e13, 0.0, True),
    (7, 3.0e13, 3.0e-16, True),
])
def test_heating_chemistry_pass_matches_in_graph_pass(monkeypatch, seed, dt,
                                                      ccf, damped):
    if damped:
        monkeypatch.setattr(j_gp, "DAMP_AFTER", 2)
        monkeypatch.setattr(t_gp, "DAMP_AFTER", 2)
    nit = _check(*_run_both_heating(seed, dt, ccf), rtol=1e-9, atol=1e-12)
    if damped:
        assert nit > 2, "the pass must reach the damped iterations"


def test_heating_config_needs_cooling_tables():
    with pytest.raises(ValueError, match="cooling"):
        t_gp.ChemistryConfig(isothermal=False)
    with pytest.raises(ValueError, match="cooling"):
        t_gp.ChemistryConfig()
