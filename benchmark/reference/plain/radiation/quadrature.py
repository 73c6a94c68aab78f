"""Photo-ionization rates by exponential-sum quadrature.

Port of ``c2ray_tpu/radiation/quadrature.py``.  Each band integral of
the source SED attenuated by e^{-tau sighat(nu)} is a fixed K-node
Gauss-Legendre sum,

    G_b(tau)      ~ sum_k A_{bk} e^{-tau sighat_{bk}}
    Gthin_b(tau)  ~ sum_k A_{bk} sighat_{bk} e^{-tau sighat_{bk}}
    H_{b,s}(tau)  ~ sum_k A_{bk} h(nu_k - nu_s) e^{-tau sighat_{bk}}

with the reference's integrand (radiation_tables.f90:593-783).  The
tables are built on the host in float64 and cast once.  The functions
below are the plain PyTorch version of the per-cell rate evaluation; on
the GPU the same arithmetic, isothermal or with heating, runs as the
device function `cell_rates` (``csrc/band_rates.cuh``) inside the sweep
kernels.  The copy keeps the fixed rule that the cells run.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from .bands import F_FACTORS, Bands, make_bands
from .photo import (PhotRates, TAU_HEAT_LIMIT, TAU_PHOTO_LIMIT, _AR2, _BR1,
                    _BR2, _CR1, _CR2, _DR1, zero_photrates)
from .sed import (SEDConfig, blackbody_photon_density, normalize_seds,
                  powerlaw_photon_density)

# Gauss-Legendre nodes per band: 6 nodes reproduce a dense 48-node rule
# to 3.7e-6 relative over tau in [1e-8, 1e7]
# (tests/test_quadrature_pin.py pins the JAX twin of this rule).
DEFAULT_NODES = 6


class SourceQuad(NamedTuple):
    """Quadrature data for one source type, shapes (nlive, K): only the
    live band range [band_lo, band_hi] is stored
    (radiation_tables.f90:194-256)."""

    band_lo: int
    band_hi: int
    sigma_hat: torch.Tensor   # attenuation exponents (nu/nu_min)^-pli
    A_photo: torch.Tensor     # photon-rate coefficients (scaled)
    A_heat_HI: Optional[torch.Tensor]
    A_heat_HeI: Optional[torch.Tensor]
    A_heat_HeII: Optional[torch.Tensor]


class QuadTables(NamedTuple):
    """Everything the quadrature rate evaluation needs."""

    bb: Optional[SourceQuad]
    pl: Optional[SourceQuad]
    qso: Optional[SourceQuad]
    sigma_HI: torch.Tensor
    sigma_HeI: torch.Tensor
    sigma_HeII: torch.Tensor
    f1ion_HI: torch.Tensor
    f1ion_HeI: torch.Tensor
    f1ion_HeII: torch.Tensor
    f2ion_HI: torch.Tensor
    f2ion_HeI: torch.Tensor
    f2ion_HeII: torch.Tensor
    f1heat_HI: torch.Tensor
    f1heat_HeI: torch.Tensor
    f1heat_HeII: torch.Tensor
    f2heat_HI: torch.Tensor
    f2heat_HeI: torch.Tensor
    f2heat_HeII: torch.Tensor
    mask_HeI: torch.Tensor
    mask_HeII: torch.Tensor


def _band_quadrature(bands: Bands, sed_fn, band_lo, band_hi, isothermal,
                     n_nodes, dtype, device):
    nb = bands.nbands
    K = n_nodes
    xk, wk = np.polynomial.legendre.leggauss(K)

    sigma_hat = np.zeros((nb, K))
    A_photo = np.zeros((nb, K))
    A_heat = None if isothermal else np.zeros((3, nb, K))
    thresholds = (const.ion_freq_HI, const.ion_freq_HeI, const.ion_freq_HeII)

    for b in range(nb):
        if b < band_lo or b > band_hi:
            # dead band for this source type: dropped by the slice below
            sigma_hat[b] = 1.0
            continue
        lo, hi = bands.freq_min[b], bands.freq_max[b]
        nu = 0.5 * (hi - lo) * xk + 0.5 * (hi + lo)
        w = 0.5 * (hi - lo) * wk
        if b < bands.nbnd1:
            pli = bands.pli_HI[b]
            species = (0,)
        elif b < bands.nbnd1 + bands.nbnd2:
            pli = bands.pli_HeI[b]
            species = (0, 1)
        else:
            pli = bands.pli_HeII[b]
            species = (0, 1, 2)
        sigma_hat[b] = (nu / lo) ** (-pli)
        A_photo[b] = w * sed_fn(nu)
        if A_heat is not None:
            for s in species:
                A_heat[s, b] = A_photo[b] * const.hplanck * (
                    nu - thresholds[s])

    lo_b, hi_b = int(band_lo), int(min(band_hi, nb - 1))
    sl = slice(lo_b, hi_b + 1)
    to = lambda a: torch.as_tensor(a[sl], dtype=dtype, device=device)
    return SourceQuad(
        band_lo=lo_b, band_hi=hi_b,
        sigma_hat=to(sigma_hat),
        A_photo=to(A_photo),
        A_heat_HI=None if A_heat is None else to(A_heat[0]),
        A_heat_HeI=None if A_heat is None else to(A_heat[1]),
        A_heat_HeII=None if A_heat is None else to(A_heat[2]),
    )


def _bb_band_limits(bands: Bands, h_over_kT) -> tuple:
    """BB usable band range: cut when h nu_min/kT > 25
    (radiation_tables.f90:194-199)."""
    hi = bands.nbands - 1
    for b in range(bands.nbands):
        if bands.freq_min[b] * h_over_kT > 25.0:
            hi = b - 1
            break
    return 0, hi


def _pl_band_limits(bands: Bands, min_freq, max_freq) -> tuple:
    """PL/QSO band range (radiation_tables.f90:208-256)."""
    hi = bands.nbands - 1
    for b in range(bands.nbands):
        if bands.freq_min[b] > max_freq:
            hi = b - 1
            break
    lo = 0
    for b in range(bands.nbands - 1, -1, -1):
        if bands.freq_min[b] < min_freq:
            lo = b
            break
    return lo, hi


def build_quadrature_tables(sed: SEDConfig, bands: Optional[Bands] = None, *,
                            isothermal=False, dtype=torch.float32,
                            n_nodes=DEFAULT_NODES,
                            flux_scale: Optional[float] = None,
                            device=None):
    """Quadrature tables for the configured SEDs.

    Returns (QuadTables, normalized SEDConfig, Bands-with-flux_scale).
    In float32 the tables are divided by the summed S_star (the photon
    rates ~1e49 and up overflow float32); float64 keeps flux_scale = 1.
    `n_nodes` is the nodes per band.
    """
    if bands is None:
        bands = make_bands()
    sed = normalize_seds(sed, bands.freq_min[0], bands.freq_max[-1],
                         edges=bands.freq_max[:-1])
    if flux_scale is None:
        if dtype == torch.float64:
            flux_scale = 1.0
        else:
            flux_scale = sum(s.S_star for s in (sed.bb, sed.pl, sed.qso)
                             if s is not None)
    inv = 1.0 / flux_scale

    def build(fn, lo, hi):
        return _band_quadrature(bands, fn, lo, hi, isothermal, int(n_nodes),
                                dtype, device)

    bb = pl = qso = None
    if sed.bb is not None:
        lo, hi = _bb_band_limits(bands, sed.bb.h_over_kT)
        R2 = sed.bb.R_star**2
        bb = build(
            lambda f: inv * 4.0 * const.pi * R2
            * blackbody_photon_density(f, sed.bb.h_over_kT), lo, hi)
    if sed.pl is not None:
        lo, hi = _pl_band_limits(bands, sed.pl.min_freq, sed.pl.max_freq)
        pl = build(
            lambda f: inv * sed.pl.scaling
            * powerlaw_photon_density(f, sed.pl.index), lo, hi)
    if sed.qso is not None:
        lo, hi = _pl_band_limits(bands, sed.qso.min_freq, sed.qso.max_freq)
        qso = build(
            lambda f: inv * sed.qso.scaling
            * powerlaw_photon_density(f, sed.qso.index), lo, hi)

    nb = bands.nbands
    n1, n2 = bands.nbnd1, bands.nbnd2
    zeros = np.zeros(nb)
    f = {name: getattr(bands, name) if getattr(bands, name) is not None
         else zeros
         for name in F_FACTORS}
    arr = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    dtype=dtype, device=device)
    qt = QuadTables(
        bb=bb, pl=pl, qso=qso,
        sigma_HI=arr(bands.sigma_HI), sigma_HeI=arr(bands.sigma_HeI),
        sigma_HeII=arr(bands.sigma_HeII),
        mask_HeI=arr((np.arange(nb) >= n1).astype(float)),
        mask_HeII=arr((np.arange(nb) >= n1 + n2).astype(float)),
        **{k: arr(v) for k, v in f.items()},
    )
    bands = dataclasses.replace(bands, flux_scale=float(flux_scale))
    return qt, sed, bands


def _attenuation(sq: SourceQuad, tau):
    """e^{-tau sighat_k}: tau (..., nb) -> (..., nb, K)."""
    expo = tau[..., None] * sq.sigma_hat
    return torch.exp(-torch.clamp(expo, max=80.0))


def _one_source_quad(qt: QuadTables, sq: SourceQuad, nflux,
                     cd_in_HI, cd_out_HI, cd_in_HeI, cd_out_HeI,
                     cd_in_HeII, cd_out_HeII,
                     vol, i_state, do_heating, track_bands=False
                     ) -> PhotRates:
    """Photo + heating rates for one source type, on its live band
    range only (radiation_tables.f90:194-256).  `track_bands` also
    returns the outgoing photon rate per band, this type's live slice
    padded into the full band axis."""
    sl = slice(sq.band_lo, sq.band_hi + 1)
    dtype = cd_in_HI.dtype
    sig_HI = qt.sigma_HI[sl]
    sig_HeI = qt.sigma_HeI[sl]
    sig_HeII = qt.sigma_HeII[sl]
    mask_HeI = qt.mask_HeI[sl]
    mask_HeII = qt.mask_HeII[sl]

    tau_in = (cd_in_HI[..., None] * sig_HI
              + cd_in_HeI[..., None] * sig_HeI
              + cd_in_HeII[..., None] * sig_HeII)
    tau_out = (cd_out_HI[..., None] * sig_HI
               + cd_out_HeI[..., None] * sig_HeI
               + cd_out_HeII[..., None] * sig_HeII)

    # per-species cell optical depths and the tau-weighted split of the
    # band rate between species (scale_int2/3,
    # radiation_photoionrates.f90:787-823)
    tau_cell_HI = sig_HI * (cd_out_HI - cd_in_HI)[..., None]
    tau_cell_HeI = sig_HeI * (cd_out_HeI - cd_in_HeI)[..., None]
    tau_cell_HeII = sig_HeII * (cd_out_HeII - cd_in_HeII)[..., None]
    denom = tau_cell_HI + tau_cell_HeI + tau_cell_HeII
    inv = 1.0 / torch.clamp(denom, min=torch.finfo(dtype).tiny)
    scaling_HI = tau_cell_HI * inv
    scaling_HeI = tau_cell_HeI * inv
    scaling_HeII = tau_cell_HeII * inv

    nfl = nflux[..., None]
    volk = vol[..., None]
    E_in = _attenuation(sq, tau_in)     # (..., nlive, K)
    E_out = _attenuation(sq, tau_out)
    dtau = tau_out - tau_in

    phi_in = nfl * (sq.A_photo * E_in).sum(-1)
    thick = torch.abs(dtau) > TAU_PHOTO_LIMIT
    phi_all_thick = nfl * (sq.A_photo * (E_in - E_out)).sum(-1)
    phi_all_thin = nfl * dtau * (sq.A_photo * sq.sigma_hat * E_in).sum(-1)
    phi_all = torch.where(thick, phi_all_thick, phi_all_thin)
    phi_out = phi_in - phi_all

    photo_cell_HI = (scaling_HI * phi_all / volk).sum(-1)
    photo_cell_HeI = (mask_HeI * scaling_HeI * phi_all / volk).sum(-1)
    photo_cell_HeII = (mask_HeII * scaling_HeII * phi_all / volk).sum(-1)

    if track_bands:
        # pad this source type's live slice into the full band axis
        # (c2ray_tpu/radiation/quadrature.py:388-394)
        pob = torch.zeros(phi_out.shape[:-1] + (qt.sigma_HI.shape[0],),
                          dtype=dtype, device=phi_out.device)
        pob[..., sl] = phi_out
    else:
        pob = torch.zeros((), dtype=dtype, device=phi_out.device)
    out = PhotRates(
        photo_cell_HI=photo_cell_HI, photo_cell_HeI=photo_cell_HeI,
        photo_cell_HeII=photo_cell_HeII,
        heat=torch.zeros_like(photo_cell_HI),
        photo_in=phi_in.sum(-1), photo_out=phi_out.sum(-1),
        photo_out_bands=pob)

    if not do_heating or sq.A_heat_HI is None:
        return out

    hthick = torch.abs(dtau) > TAU_HEAT_LIMIT

    def species_heat(A, tau_cell, scaling, mask):
        ph_thick = scaling * nfl * (A * (E_in - E_out)).sum(-1) / volk
        ph_thin = nfl * tau_cell * (A * sq.sigma_hat * E_in).sum(-1) / volk
        return mask * torch.where(hthick, ph_thick, ph_thin)

    one = torch.ones_like(mask_HeI)
    ph_HI = species_heat(sq.A_heat_HI, tau_cell_HI, scaling_HI, one)
    ph_HeI = species_heat(sq.A_heat_HeI, tau_cell_HeI, scaling_HeI,
                          mask_HeI)
    ph_HeII = species_heat(sq.A_heat_HeII, tau_cell_HeII, scaling_HeII,
                           mask_HeII)

    df_heat = ph_HI + ph_HeI + ph_HeII
    x = i_state[..., None]

    def y1R(i):
        return _CR1[i] * (1.0 - x ** _BR1[i]) ** _DR1[i]

    def y2R(i):
        xeb = 1.0 - x ** _BR2[i]
        return _CR2[i] * x ** _AR2[i] * xeb * xeb

    fra1 = (qt.f1ion_HI[sl] * ph_HI + qt.f1ion_HeI[sl] * ph_HeI
            + qt.f1ion_HeII[sl] * ph_HeII)
    fra2 = (qt.f2ion_HI[sl] * ph_HI + qt.f2ion_HeI[sl] * ph_HeI
            + qt.f2ion_HeII[sl] * ph_HeII)
    fra3 = (qt.f1heat_HI[sl] * ph_HI + qt.f1heat_HeI[sl] * ph_HeI
            + qt.f1heat_HeII[sl] * ph_HeII)
    fra4 = (qt.f2heat_HI[sl] * ph_HI + qt.f2heat_HeI[sl] * ph_HeI
            + qt.f2heat_HeII[sl] * ph_HeII)

    f_heat = (df_heat - y1R(2) * fra3 + y2R(2) * fra4).sum(-1)
    f_ion_HI = (y1R(0) * fra1 - y2R(0) * fra2).sum(-1)
    f_ion_HeI = (y1R(1) * fra1 - y2R(1) * fra2).sum(-1)

    return out._replace(
        photo_cell_HI=out.photo_cell_HI
        + f_ion_HI / (const.ion_freq_HI * const.hplanck),
        photo_cell_HeI=out.photo_cell_HeI
        + f_ion_HeI / (const.ion_freq_HeI * const.hplanck),
        heat=f_heat)


def photoion_rates_quad(
    qt: QuadTables,
    colum_in_HI, colum_out_HI,
    colum_in_HeI, colum_out_HeI,
    colum_in_HeII, colum_out_HeII,
    vol,
    i_state,
    nflux_bb=None,
    nflux_pl=None,
    nflux_qso=None,
    do_heating: bool = True,
    track_bands: bool = False,
) -> PhotRates:
    """Cell photo-ionization and heating rates from the in/out columns
    (the contract of the reference's photoion_rates,
    radiation_photoionrates.f90:108-823).  Scalars broadcast to the
    column shape; device and dtype follow `colum_in_HI`.
    `track_bands` also fills PhotRates.photo_out_bands, the outgoing
    photon rate over the full band axis (the input of the photon-loss
    redistribution, sweep/photon_losses.py)."""
    cd_in_HI = colum_in_HI
    shape = cd_in_HI.shape
    dtype, device = cd_in_HI.dtype, cd_in_HI.device
    bcast = lambda a: torch.broadcast_to(
        torch.as_tensor(a, dtype=dtype, device=device), shape)
    vol = bcast(vol)
    i_state = bcast(i_state)

    phi = zero_photrates(shape, dtype, device,
                         nbands=qt.sigma_HI.shape[0] if track_bands else 0)
    for sq, nflux in ((qt.bb, nflux_bb), (qt.pl, nflux_pl),
                      (qt.qso, nflux_qso)):
        if sq is None or nflux is None:
            continue
        nflux = bcast(nflux)
        phi = phi + _one_source_quad(
            qt, sq, nflux,
            cd_in_HI, colum_out_HI, colum_in_HeI, colum_out_HeI,
            colum_in_HeII, colum_out_HeII, vol, i_state, do_heating,
            track_bands)
    return phi
