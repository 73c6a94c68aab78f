"""Photoionization / heating rate tables (tau-indexed).

Port of ``c2ray_tpu/radiation/tables.py`` (``code/radiation_tables.f90``):
for every frequency sub-band, integrate  SED(nu) * exp(-tau *
sigma(nu)/sigma_0)  ("thick") and the same integrand multiplied by
sigma(nu)/sigma_0 ("thin") over the sub-band, for a log-spaced grid of
2001 optical depths (radiation_tables.f90:59-61, 593-660), plus heating
variants weighted by h*(nu - nu_threshold) per absorbing species
(radiation_tables.f90:664-783).

Host code: the tables are integrated in float64 numpy, exactly as the
JAX package integrates them, and cast once to torch tensors.  Band-range
restrictions per source type (BB exp cutoff at h nu/kT > 25, PL/QSO
frequency limits, radiation_tables.f90:194-256) are applied by zeroing
table columns.  These tables feed the reference-parity rate route
(`radiation/photo.py:photoion_rates`, and on the card the table variant
of ``csrc/evolve1d.cu``); the quadrature route does not use them.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..romberg import romberg_weights
from .bands import F_FACTORS, Bands, NumFreq, NumTau, make_bands
from .sed import (SEDConfig, blackbody_photon_density, normalize_seds,
                  powerlaw_photon_density)

minlogtau = -20.0  # radiation_tables.f90:59
maxlogtau = 4.0    # radiation_tables.f90:60
dlogtau = (maxlogtau - minlogtau) / NumTau


class SourceTypeTables(NamedTuple):
    """Rate tables for one source type (shapes: (NumTau+1, nbands) photo,
    (NumTau+1, nheatbins) heat)."""

    photo_thick: torch.Tensor
    photo_thin: torch.Tensor
    heat_thick: Optional[torch.Tensor]
    heat_thin: Optional[torch.Tensor]


class RadiationTables(NamedTuple):
    """Everything the tau-table rate lookup needs."""

    # per-source-type tables (None when the source type is absent)
    bb: Optional[SourceTypeTables]
    pl: Optional[SourceTypeTables]
    qso: Optional[SourceTypeTables]
    # band data needed at runtime, shape (nbands,)
    sigma_HI: torch.Tensor
    sigma_HeI: torch.Tensor
    sigma_HeII: torch.Tensor
    # secondary-ionization factors (zeros when isothermal), shape (nbands,)
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
    # heating-table column index per (band, species), int64; invalid -> 0
    hbin_HI: torch.Tensor
    hbin_HeI: torch.Tensor
    hbin_HeII: torch.Tensor
    # species validity masks per band (float 0/1)
    mask_HeI: torch.Tensor
    mask_HeII: torch.Tensor


def _tau_grid() -> np.ndarray:
    """tau(0)=0, then 10^(minlogtau + dlogtau*(i-1))
    (radiation_tables.f90:183-188)."""
    tau = np.zeros(NumTau + 1)
    i = np.arange(1, NumTau + 1)
    tau[1:] = 10.0 ** (minlogtau + dlogtau * (i - 1))
    return tau


def _build_source_tables(bands: Bands, sed_photon_density, band_lo, band_hi,
                         isothermal, dtype, device=None):
    """Integrate the thick/thin photo and heating tables for one source.

    ``sed_photon_density(freq)``: photon-sense SED already scaled
    (includes 4 pi R*^2 or pl_scaling).
    Bands outside [band_lo, band_hi] (inclusive, 0-based) get zero columns.
    """
    nb = bands.nbands
    tau = _tau_grid()                       # (ntau,)
    w = romberg_weights(NumFreq)            # (nf,)

    photo_thick = np.zeros((NumTau + 1, nb))
    photo_thin = np.zeros((NumTau + 1, nb))
    heat_thick = None if isothermal else np.zeros((NumTau + 1, bands.nheatbins))
    heat_thin = None if isothermal else np.zeros((NumTau + 1, bands.nheatbins))

    thresholds = (const.ion_freq_HI, const.ion_freq_HeI, const.ion_freq_HeII)
    # species whose heating bins exist per band region, and the power-law
    # index of the cross-section frequency dependence used per band
    # (radiation_tables.f90:264-388): band1 -> HI index, band2 -> HeI,
    # band3 -> HeII.
    for b in range(nb):
        if b < band_lo or b > band_hi:
            continue
        freq = bands.freq_min[b] + bands.delta_freq[b] * np.arange(NumFreq + 1)
        if b < bands.nbnd1:
            pli = bands.pli_HI[b]
            species = (0,)
        elif b < bands.nbnd1 + bands.nbnd2:
            pli = bands.pli_HeI[b]
            species = (0, 1)
        else:
            pli = bands.pli_HeII[b]
            species = (0, 1, 2)
        # sigma(nu)/sigma_0 within the band (radiation_tables.f90:569-588)
        csfd = (freq / bands.freq_min[b]) ** (-pli)          # (nf,)
        sed = sed_photon_density(freq)                       # (nf,)

        # exp(-tau * csfd) with overflow guard (radiation_tables.f90:607)
        expo = tau[:, None] * csfd[None, :]                  # (ntau, nf)
        atten = np.where(expo < 700.0, np.exp(-np.minimum(expo, 700.0)), 0.0)

        integ_thick = sed[None, :] * atten                   # (ntau, nf)
        integ_thin = integ_thick * csfd[None, :]
        dnu = bands.delta_freq[b]
        photo_thick[:, b] = (integ_thick * w[None, :]).sum(axis=1) * dnu
        photo_thin[:, b] = (integ_thin * w[None, :]).sum(axis=1) * dnu

        if not isothermal:
            for s in species:
                hw = const.hplanck * (freq - thresholds[s])  # (nf,)
                col = bands.heat_bin_index(b, s)
                heat_thick[:, col] = ((integ_thick * hw[None, :]) * w[None, :]
                                      ).sum(axis=1) * dnu
                heat_thin[:, col] = ((integ_thin * hw[None, :]) * w[None, :]
                                     ).sum(axis=1) * dnu

    to = lambda a: (None if a is None else
                    torch.as_tensor(a, dtype=dtype, device=device))
    return SourceTypeTables(photo_thick=to(photo_thick),
                            photo_thin=to(photo_thin),
                            heat_thick=to(heat_thick),
                            heat_thin=to(heat_thin))


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


def build_radiation_tables(sed: SEDConfig, bands: Optional[Bands] = None, *,
                           isothermal=False, dtype=torch.float64,
                           flux_scale: Optional[float] = None,
                           device=None) -> tuple:
    """Full `rad_ini` equivalent (radiation_tables.f90:141-168).

    Normalizes the SEDs against the band range and integrates all tables.
    Returns (RadiationTables, normalized SEDConfig, Bands).

    ``flux_scale``: tables are stored divided by this factor so their
    values stay in float32 range (S_star ~ 1e48-1e57 overflows f32).
    The rate lookup recovers physical cell rates by dividing the shell
    volume by the same factor.  Defaults to 1.0 for float64 and to the
    total source photon rate otherwise.
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

    bb_tables = pl_tables = qso_tables = None
    inv = 1.0 / flux_scale
    build = lambda fn, lo, hi: _build_source_tables(bands, fn, lo, hi,
                                                    isothermal, dtype, device)
    if sed.bb is not None:
        lo, hi = _bb_band_limits(bands, sed.bb.h_over_kT)
        R2 = sed.bb.R_star**2
        bb_tables = build(
            lambda f: inv * 4.0 * const.pi * R2
            * blackbody_photon_density(f, sed.bb.h_over_kT), lo, hi)
    if sed.pl is not None:
        lo, hi = _pl_band_limits(bands, sed.pl.min_freq, sed.pl.max_freq)
        pl_tables = build(
            lambda f: inv * sed.pl.scaling
            * powerlaw_photon_density(f, sed.pl.index), lo, hi)
    if sed.qso is not None:
        lo, hi = _pl_band_limits(bands, sed.qso.min_freq, sed.qso.max_freq)
        qso_tables = build(
            lambda f: inv * sed.qso.scaling
            * powerlaw_photon_density(f, sed.qso.index), lo, hi)

    nb = bands.nbands
    n1, n2 = bands.nbnd1, bands.nbnd2
    hbin_HI = np.array([bands.heat_bin_index(b, 0) for b in range(nb)])
    hbin_HeI = np.array([bands.heat_bin_index(b, 1) if b >= n1 else 0
                         for b in range(nb)])
    hbin_HeII = np.array([bands.heat_bin_index(b, 2) if b >= n1 + n2 else 0
                          for b in range(nb)])
    mask_HeI = (np.arange(nb) >= n1).astype(np.float64)
    mask_HeII = (np.arange(nb) >= n1 + n2).astype(np.float64)

    zeros = np.zeros(nb)
    f = {name: getattr(bands, name) if getattr(bands, name) is not None
         else zeros
         for name in F_FACTORS}

    arr = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    tables = RadiationTables(
        bb=bb_tables, pl=pl_tables, qso=qso_tables,
        sigma_HI=arr(bands.sigma_HI), sigma_HeI=arr(bands.sigma_HeI),
        sigma_HeII=arr(bands.sigma_HeII),
        hbin_HI=idx(hbin_HI), hbin_HeI=idx(hbin_HeI),
        hbin_HeII=idx(hbin_HeII),
        mask_HeI=arr(mask_HeI), mask_HeII=arr(mask_HeII),
        **{k: arr(v) for k, v in f.items()},
    )
    bands = dataclasses.replace(bands, flux_scale=float(flux_scale))
    return tables, sed, bands


class TableRoute(NamedTuple):
    """The tau tables as the kernels read them (csrc/table_rates.cuh):
    rows (nb, 17) of [sig_HI, sig_HeI, sig_HeII, mask_HeI, mask_HeII, the
    12 f-factors in F_FACTORS order]; hbin (nb, 3) int32, the heating
    column of each band and species; photo (ntypes, 2, NumTau + 1, nb)
    the thick and thin photo tables of each source type in use; with
    heating heat (ntypes, 2, NumTau + 1, nheat); cols the nflux column
    of each type; live the bands [b0, b1) from the first to the last
    where some type's photo tables are nonzero (live_band_range)."""

    rows: torch.Tensor
    hbin: torch.Tensor
    photo: torch.Tensor
    heat: Optional[torch.Tensor]
    cols: tuple
    live: tuple


def live_band_range(photo: torch.Tensor) -> tuple:
    """(b0, b1): the bands from the first to the last whose column of
    some source type's photo tables (photo: (..., nb)) is nonzero --
    _build_source_tables zeroes the columns outside a type's band range
    (_bb_band_limits, _pl_band_limits), and so its heating columns; the
    rates of the bands outside add nothing.  (0, 0) when every column is
    zero."""
    live = torch.nonzero(photo.reshape(-1, photo.shape[-1]).ne(0)
                         .any(dim=0)).flatten().tolist()
    return (live[0], live[-1] + 1) if live else (0, 0)


def packed_table_route(rt: RadiationTables, dtype, device, heat: bool,
                       has_bb=True, has_pl=False, has_qso=False
                       ) -> TableRoute:
    """The tau tables of the source types in use, packed for the kernels
    (the 1D march and the three 3D sweeps)."""
    types = [(t, col) for col, (t, used) in enumerate(
        ((rt.bb, has_bb), (rt.pl, has_pl), (rt.qso, has_qso)))
        if t is not None and used]
    if not types:
        raise ValueError("the rates need at least one source type")
    if heat and any(t.heat_thick is None for t, _ in types):
        raise ValueError("heating rates need heating tables "
                         "(build_radiation_tables(isothermal=False))")
    to = lambda t: t.to(dtype=dtype, device=device).contiguous()
    cols = [rt.sigma_HI, rt.sigma_HeI, rt.sigma_HeII, rt.mask_HeI,
            rt.mask_HeII] + [getattr(rt, f) for f in F_FACTORS]
    hbin = torch.stack([rt.hbin_HI, rt.hbin_HeI, rt.hbin_HeII], dim=-1)
    photo = to(torch.stack([torch.stack([t.photo_thick, t.photo_thin])
                            for t, _ in types]))
    heat_tab = (to(torch.stack([torch.stack([t.heat_thick, t.heat_thin])
                                for t, _ in types])) if heat else None)
    return TableRoute(rows=to(torch.stack(cols, dim=-1)),
                      hbin=hbin.to(dtype=torch.int32,
                                   device=device).contiguous(),
                      photo=photo, heat=heat_tab,
                      cols=tuple(col for _, col in types),
                      live=live_band_range(photo))


class PackedTauTables(NamedTuple):
    """The tau tables as the 3D sweep kernels read them
    (csrc/table_rates.cuh: table_rates), band-major: for each source
    type in use and each live band b0 <= b < b1 a column over the
    NumTau + 1 rows, each row one record [v_thick[i], v_thick[i1] -
    v_thick[i], v_thin[i], v_thin[i1] - v_thin[i]] (i1 = min(i + 1,
    NumTau), photo.py:_table_positions' next row), so that one 16-byte
    load (float32; two in float64) gives both reads of photo.py:_read
    at a row.  photo (ntypes, b1 - b0, NumTau + 1, 4) of the photo
    tables; with heating heat (ntypes, b1 - b0, 3, NumTau + 1, 4) of the
    heating tables at each band's column per species (hbin resolved);
    rows, cols and live as TableRoute's.  The differences are the same
    IEEE subtraction in the same dtype that the reads do, so every read
    v + d r is the unpacked read's to the bit."""

    rows: torch.Tensor
    photo: torch.Tensor
    heat: Optional[torch.Tensor]
    cols: tuple
    live: tuple


def _tau_records(thick, thin, row_dim):
    """Records [v, next - v] of the thick and thin tables along the
    table rows (dim row_dim; the next row capped at the last), as a new
    last axis of 4."""
    def v_and_d(t):
        last = t.narrow(row_dim, t.shape[row_dim] - 1, 1)
        nxt = torch.cat([t.narrow(row_dim, 1, t.shape[row_dim] - 1), last],
                        dim=row_dim)
        return t, nxt - t

    return torch.stack([*v_and_d(thick), *v_and_d(thin)], dim=-1)


def pack_tau_columns(tr: TableRoute) -> PackedTauTables:
    """TableRoute's tables band-major (PackedTauTables), made with torch
    operations on the tables' device (on the card for the kernels'
    tables), once per table set (sweep/source_sweep.py caches them)."""
    b0, b1 = tr.live
    # photo (ntypes, 2, rows, nb) -> (ntypes, rows, nlive, 4) -> band-major
    photo = _tau_records(tr.photo[:, 0, :, b0:b1], tr.photo[:, 1, :, b0:b1],
                         row_dim=1).permute(0, 2, 1, 3).contiguous()
    heat = None
    if tr.heat is not None:
        cols = tr.hbin[b0:b1].long()                 # (nlive, 3)
        # heat (ntypes, 2, rows, nheat) -> (ntypes, rows, nlive, 3, 4)
        rec = _tau_records(tr.heat[:, 0][:, :, cols],
                           tr.heat[:, 1][:, :, cols], row_dim=1)
        heat = rec.permute(0, 2, 3, 1, 4).contiguous()
    return PackedTauTables(rows=tr.rows, photo=photo, heat=heat,
                           cols=tr.cols, live=tr.live)


def read_tau_column(column, ipos, residual, thin: bool = False):
    """photo.py:_read on one band-major column (PackedTauTables' photo
    [t, b - b0] or heat [t, b - b0, species]: (NumTau + 1, 4)) at rows
    ipos with residuals `residual` -- the kernel's read, v + d r of the
    row's thick (or thin) record: the plain version of what
    table_rates' record loads compute."""
    rec = column[ipos]
    k = 2 if thin else 0
    return rec[..., k] + rec[..., k + 1] * residual
