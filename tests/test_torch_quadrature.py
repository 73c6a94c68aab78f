"""Quadrature band rates: the port's plain version against the JAX one.

Random column sets spanning optical depths tau in [1e-8, 1e7] go
through `photoion_rates_quad` of both packages in float64, isothermal
and with heating, for blackbody and power-law sources.  Both evaluate
the same sums term by term, so they agree to float64 rounding:
rtol 1e-12, with an absolute floor of 1e-12 of each output's largest
value (outputs that cancel to ~0 carry only rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu import constants as const
from c2ray_tpu.radiation import sed as j_sed
from c2ray_tpu.radiation.quadrature import build_quadrature_tables
from c2ray_tpu.radiation.quadrature import \
    photoion_rates_quad as j_rates
from c2ray_tpu_torch import convert
from c2ray_tpu_torch.radiation.quadrature import \
    photoion_rates_quad as t_rates

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

RTOL = 1e-12


def _columns(rng, n):
    """In/out columns whose HI optical depth spans tau in [1e-8, 1e7]."""
    tau = 10.0 ** rng.uniform(-8.0, 7.0, n)
    cin_HI = tau / const.sigma_HI_at_ion_freq
    cin_HeI = cin_HI * 10.0 ** rng.uniform(-3.0, -0.5, n)
    cin_HeII = cin_HI * 10.0 ** rng.uniform(-4.0, -1.0, n)
    # cell increments from optically thin to thick, dtau/tau in
    # [1e-6, 1]: smaller ratios make tau_out - tau_in cancel, and both
    # packages' results would be rounding noise there
    dtau = tau * 10.0 ** rng.uniform(-6.0, 0.0, n)
    dHI = dtau / const.sigma_HI_at_ion_freq
    cout = [cin_HI + dHI, cin_HeI + dHI * rng.uniform(0.0, 0.2, n),
            cin_HeII + dHI * rng.uniform(0.0, 0.1, n)]
    return [cin_HI, cout[0], cin_HeI, cout[1], cin_HeII, cout[2]]


_SEDS = {
    "bb": lambda m: m.SEDConfig(bb=m.BlackBodySED(T_eff=5e4, S_star=3e51)),
    "pl": lambda m: m.SEDConfig(pl=m.PowerLawSED(index=2.5, S_star=1e48)),
}


@pytest.mark.parametrize("heating", [False, True])
@pytest.mark.parametrize("kind", ["bb", "pl"])
def test_photoion_rates_quad_matches_jax(kind, heating):
    qt, _, bands = build_quadrature_tables(_SEDS[kind](j_sed),
                                           isothermal=not heating,
                                           dtype=jnp.float64)
    tq = convert.quad_tables_from_numpy(qt)
    rng = np.random.RandomState(11)
    n = 4000
    cols = _columns(rng, n)
    vol = 10.0 ** rng.uniform(-3.0, 6.0, n)
    istate = rng.uniform(1e-6, 1.0, n)
    nflux = rng.uniform(0.5, 2.0, n)
    kw = {f"nflux_{kind}": nflux}

    ref = j_rates(qt, *[jnp.asarray(c) for c in cols], jnp.asarray(vol),
                  jnp.asarray(istate), do_heating=heating,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    got = t_rates(tq, *[torch.as_tensor(c) for c in cols],
                  torch.as_tensor(vol), torch.as_tensor(istate),
                  do_heating=heating,
                  **{k: torch.as_tensor(v) for k, v in kw.items()})
    for name in got._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        scale = np.abs(b).max()
        # no heat when isothermal; no per-band escape when the bands are
        # not tracked (tests/test_torch_photon_losses.py tracks them)
        if (name == "heat" and not heating) or name == "photo_out_bands":
            assert scale == 0.0 and np.all(a == 0.0)
            continue
        assert scale > 0.0, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=name)


def test_scalar_arguments_broadcast():
    """vol, i_state and the flux may be scalars (the source cell)."""
    qt, _, _ = build_quadrature_tables(_SEDS["bb"](j_sed), isothermal=True,
                                       dtype=jnp.float64)
    tq = convert.quad_tables_from_numpy(qt)
    cols = [np.array([0.0]), np.array([1e17]), np.array([0.0]),
            np.array([1e15]), np.array([0.0]), np.array([1e14])]
    ref = j_rates(qt, *[jnp.asarray(c) for c in cols], 2.5, 0.3,
                  nflux_bb=1.5, do_heating=False)
    got = t_rates(tq, *[torch.as_tensor(c) for c in cols], 2.5, 0.3,
                  nflux_bb=1.5, do_heating=False)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=0.0, err_msg=name)
