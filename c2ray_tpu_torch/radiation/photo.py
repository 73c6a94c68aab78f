"""Photo-ionization / heating rates from the tau tables.

Port of ``c2ray_tpu/radiation/photo.py``
(``code/radiation_photoionrates.f90:108-823``): the `PhotRates` record,
the optically-thin thresholds, the Ricotti et al. 2002
secondary-ionization coefficients (radiation_photoionrates.f90:49-56)
and the tau-table route, `photoion_rates`: every input may carry
leading batch dimensions and the band loop is a trailing axis.  This is
the plain version of the table lookups that the table variant of the
1D kernel (``csrc/evolve1d.cu``) runs per band and lane.
"""

from typing import NamedTuple

import torch

from .. import constants as const
from .bands import NumTau
from .tables import RadiationTables, SourceTypeTables, dlogtau, minlogtau

# optical depth thresholds for the optically-thin branches
TAU_PHOTO_LIMIT = 1.0e-7   # radiation_photoionrates.f90:342
TAU_HEAT_LIMIT = 1.0e-4    # radiation_photoionrates.f90:482

# Ricotti et al. 2002 secondary-ionization coefficients
# (radiation_photoionrates.f90:49-56)
_CR1 = (0.3908, 0.0554, 1.0)
_BR1 = (0.4092, 0.4614, 0.2663)
_DR1 = (1.7592, 1.6660, 1.3163)
_CR2 = (0.6941, 0.0984, 3.9811)
_AR2 = (0.2, 0.2, 0.4)
_BR2 = (0.38, 0.38, 0.34)


class PhotRates(NamedTuple):
    """Photo-ionization + heating rates for a batch of cells
    (the used fields of the reference `photrates` type,
    radiation_photoionrates.f90:59-81)."""

    photo_cell_HI: torch.Tensor
    photo_cell_HeI: torch.Tensor
    photo_cell_HeII: torch.Tensor
    heat: torch.Tensor
    photo_in: torch.Tensor
    photo_out: torch.Tensor
    # (..., nbands) outgoing photon rate over the full band axis when the
    # rates were asked to track bands, else a 0-d zero
    photo_out_bands: torch.Tensor = 0.0

    def __add__(self, other):
        return PhotRates(*(a + b for a, b in zip(self, other)))


def zero_photrates(shape, dtype=torch.float64, device=None,
                   nbands=0) -> PhotRates:
    z = torch.zeros(shape, dtype=dtype, device=device)
    zb = (torch.zeros(tuple(shape) + (nbands,), dtype=dtype, device=device)
          if nbands else torch.zeros((), dtype=dtype, device=device))
    return PhotRates(z, z, z, z, z, z, zb)


def _table_positions(tau):
    """Log-interpolated table positions (radiation_photoionrates.f90:282-306).

    tau: (..., nb).  Returns (ipos, ipos_p1, residual): the row is the
    truncated position, the next row is capped at NumTau.
    """
    logtau = torch.log10(torch.clamp(tau, min=1.0e-20))
    odpos = torch.clamp(1.0 + (logtau - minlogtau) / dlogtau, 0.0,
                        float(NumTau))
    ipos = odpos.to(torch.int32)
    residual = odpos - ipos.to(odpos.dtype)
    ipos_p1 = torch.clamp(ipos + 1, max=NumTau)
    return ipos.long(), ipos_p1.long(), residual


def _read(table, cols, ipos, ipos_p1, residual):
    """Linear interpolation in the tau direction of `table` at per-band
    rows: table (NumTau+1, ncols), cols (nb,) column per band, the rest
    (..., nb); result (..., nb) (radiation_photoionrates.f90:310-326)."""
    lo = table[ipos, cols]
    hi = table[ipos_p1, cols]
    return lo + (hi - lo) * residual


def _photo_lookup(tables: SourceTypeTables, nflux, band_cols,
                  tau_in, tau_out, pos_in, pos_out, vol,
                  scaling_HI, scaling_HeI, scaling_HeII,
                  mask_HeI, mask_HeII):
    """One source type's photo rates (radiation_photoionrates.f90:331-464)."""
    ip_i, ipp_i, r_i = pos_in
    ip_o, ipp_o, r_o = pos_out
    nfl = nflux[..., None]

    phi_in = nfl * _read(tables.photo_thick, band_cols, ip_i, ipp_i, r_i)
    dtau = tau_out - tau_in
    thick = torch.abs(dtau) > TAU_PHOTO_LIMIT
    phi_out_thick = nfl * _read(tables.photo_thick, band_cols, ip_o, ipp_o,
                                r_o)
    phi_all_thick = phi_in - phi_out_thick
    phi_all_thin = nfl * dtau * _read(tables.photo_thin, band_cols,
                                      ip_i, ipp_i, r_i)
    phi_all = torch.where(thick, phi_all_thick, phi_all_thin)
    phi_out = phi_in - phi_all

    volk = vol[..., None]
    photo_cell_HI = (scaling_HI * phi_all / volk).sum(-1)
    photo_cell_HeI = (mask_HeI * scaling_HeI * phi_all / volk).sum(-1)
    photo_cell_HeII = (mask_HeII * scaling_HeII * phi_all / volk).sum(-1)
    return PhotRates(
        photo_cell_HI=photo_cell_HI,
        photo_cell_HeI=photo_cell_HeI,
        photo_cell_HeII=photo_cell_HeII,
        heat=torch.zeros_like(photo_cell_HI),
        photo_in=phi_in.sum(-1),
        photo_out=phi_out.sum(-1),
        photo_out_bands=torch.zeros((), dtype=phi_in.dtype,
                                    device=phi_in.device),
    )


def _heat_lookup(rt: RadiationTables, tables: SourceTypeTables, nflux,
                 tau_in, tau_out, pos_in, pos_out,
                 tau_cell_HI, tau_cell_HeI, tau_cell_HeII,
                 vol, i_state,
                 scaling_HI, scaling_HeI, scaling_HeII):
    """One source type's heating + secondary ionizations
    (radiation_photoionrates.f90:470-779)."""
    ip_i, ipp_i, r_i = pos_in
    ip_o, ipp_o, r_o = pos_out
    nfl = nflux[..., None]
    volk = vol[..., None]
    dtau = tau_out - tau_in
    thick = torch.abs(dtau) > TAU_HEAT_LIMIT

    def species_heat(cols, tau_cell, scaling, mask):
        hin = nfl * _read(tables.heat_thick, cols, ip_i, ipp_i, r_i)
        hout = nfl * _read(tables.heat_thick, cols, ip_o, ipp_o, r_o)
        ph_thick = scaling * (hin - hout) / volk
        # the thin branch multiplies by tau_cell_species, which already
        # carries the species scaling (radiation_photoionrates.f90:633-647)
        ph_thin = nfl * tau_cell * _read(tables.heat_thin, cols,
                                         ip_i, ipp_i, r_i) / volk
        return mask * torch.where(thick, ph_thick, ph_thin)

    one = torch.ones_like(rt.mask_HeI)
    ph_HI = species_heat(rt.hbin_HI, tau_cell_HI, scaling_HI, one)
    ph_HeI = species_heat(rt.hbin_HeI, tau_cell_HeI, scaling_HeI, rt.mask_HeI)
    ph_HeII = species_heat(rt.hbin_HeII, tau_cell_HeII, scaling_HeII,
                           rt.mask_HeII)

    df_heat = ph_HI + ph_HeI + ph_HeII

    # secondary ionizations (Ricotti et al. 2002)
    x = i_state[..., None]

    def y1R(i):
        return _CR1[i] * (1.0 - x ** _BR1[i]) ** _DR1[i]

    def y2R(i):
        xeb = 1.0 - x ** _BR2[i]
        return _CR2[i] * x ** _AR2[i] * xeb * xeb

    fra1 = rt.f1ion_HI * ph_HI + rt.f1ion_HeI * ph_HeI + rt.f1ion_HeII * ph_HeII
    fra2 = rt.f2ion_HI * ph_HI + rt.f2ion_HeI * ph_HeI + rt.f2ion_HeII * ph_HeII
    fra3 = (rt.f1heat_HI * ph_HI + rt.f1heat_HeI * ph_HeI
            + rt.f1heat_HeII * ph_HeII)
    fra4 = (rt.f2heat_HI * ph_HI + rt.f2heat_HeI * ph_HeI
            + rt.f2heat_HeII * ph_HeII)

    f_heat = (df_heat - y1R(2) * fra3 + y2R(2) * fra4).sum(-1)
    f_ion_HI = (y1R(0) * fra1 - y2R(0) * fra2).sum(-1)
    f_ion_HeI = (y1R(1) * fra1 - y2R(1) * fra2).sum(-1)

    z = torch.zeros_like(f_heat)
    return PhotRates(
        photo_cell_HI=f_ion_HI / (const.ion_freq_HI * const.hplanck),
        photo_cell_HeI=f_ion_HeI / (const.ion_freq_HeI * const.hplanck),
        photo_cell_HeII=z,
        heat=f_heat,
        photo_in=z,
        photo_out=z,
        photo_out_bands=torch.zeros((), dtype=z.dtype, device=z.device),
    )


def photoion_rates(
    rt: RadiationTables,
    colum_in_HI, colum_out_HI,
    colum_in_HeI, colum_out_HeI,
    colum_in_HeII, colum_out_HeII,
    vol,
    i_state,
    nflux_bb=None,
    nflux_pl=None,
    nflux_qso=None,
    do_heating: bool = True,
) -> PhotRates:
    """The tau-table `photoion_rates` (radiation_photoionrates.f90:108-277).

    All column densities share an arbitrary leading shape; `vol`,
    `i_state` and the per-source fluxes `nflux_*` (None when the source
    type is absent) broadcast to it.  Device and dtype follow
    `colum_in_HI`.
    """
    cd_in_HI = colum_in_HI
    shape = cd_in_HI.shape
    dtype, device = cd_in_HI.dtype, cd_in_HI.device
    bcast = lambda a: torch.broadcast_to(
        torch.as_tensor(a, dtype=dtype, device=device), shape)
    vol = bcast(vol)
    i_state = bcast(i_state)

    cc_HI = colum_out_HI - cd_in_HI
    cc_HeI = colum_out_HeI - colum_in_HeI
    cc_HeII = colum_out_HeII - colum_in_HeII

    sig_HI, sig_HeI, sig_HeII = rt.sigma_HI, rt.sigma_HeI, rt.sigma_HeII
    tau_in = (cd_in_HI[..., None] * sig_HI
              + colum_in_HeI[..., None] * sig_HeI
              + colum_in_HeII[..., None] * sig_HeII)
    tau_out = (colum_out_HI[..., None] * sig_HI
               + colum_out_HeI[..., None] * sig_HeI
               + colum_out_HeII[..., None] * sig_HeII)

    pos_in = _table_positions(tau_in)
    pos_out = _table_positions(tau_out)

    # species scaling factors: tau-weighted split of the band rate over
    # species (scale_int2/scale_int3, radiation_photoionrates.f90:787-823)
    s_HI = sig_HI * cc_HI[..., None]
    s_HeI = sig_HeI * cc_HeI[..., None]
    s_HeII = sig_HeII * cc_HeII[..., None]
    denom = s_HI + s_HeI + s_HeII
    inv = 1.0 / torch.clamp(denom, min=torch.finfo(dtype).tiny)
    scaling_HI = s_HI * inv
    scaling_HeI = s_HeI * inv
    scaling_HeII = s_HeII * inv

    band_cols = torch.arange(sig_HI.shape[0], device=device)
    phi = zero_photrates(shape, dtype, device)

    sources = ((rt.bb, nflux_bb), (rt.pl, nflux_pl), (rt.qso, nflux_qso))
    for tables, nflux in sources:
        if tables is None or nflux is None:
            continue
        phi = phi + _photo_lookup(
            tables, bcast(nflux), band_cols, tau_in, tau_out, pos_in,
            pos_out, vol, scaling_HI, scaling_HeI, scaling_HeII,
            rt.mask_HeI, rt.mask_HeII)

    if do_heating:
        tau_cell_HI = cc_HI[..., None] * sig_HI
        tau_cell_HeI = cc_HeI[..., None] * sig_HeI
        tau_cell_HeII = cc_HeII[..., None] * sig_HeII
        for tables, nflux in sources:
            if tables is None or nflux is None or tables.heat_thick is None:
                continue
            phi = phi + _heat_lookup(
                rt, tables, bcast(nflux), tau_in, tau_out, pos_in, pos_out,
                tau_cell_HI, tau_cell_HeI, tau_cell_HeII,
                vol, i_state, scaling_HI, scaling_HeI, scaling_HeII)

    return phi
