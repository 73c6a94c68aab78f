"""Photon-loss redistribution: recycle escaped photons into the grid.

Port of ``c2ray_tpu/sweep/photon_losses.py`` (the 47-band completion of
the reference's disabled hook ``distribute_photon_losses``,
evolve_point.F90:654-731).  Each band's escaped photon rate ``L_b`` is
spread uniformly over the grid and attributed to the neutral species by
their absorption shares, which collapses to

    denom[c, b] = N[c, :] @ sig[:, b]          # (n, 3) @ (3, nb)
    dphi[c, s]  = (1/denom)[c, :] @ W[:, s]    # (n, nb) @ (nb, 3)

with ``W[b, s] = L_b sig_s(b) / (n V)``.  The budget closes:
sum_cells sum_s dphi_s N_s V == sum_b L_b.

`distribute_photon_losses_plain` computes this with torch matmuls;
`distribute_photon_losses_cuda` launches ``csrc/photon_losses.cu``, one
thread per cell, with the band table (`band_table`) in the kernel's
constant bank.  Both add dphi **in place** to the rate grids' phih,
phihe0 and phihe1 and return the rates.

Decided deviation from the JAX function (float32): with the 1e-30
density floor and sig ~1e-18, N @ sig falls below float32's range, so
JAX's float32 ``1/denom`` is inf in fully ionized cells.  Here sig is
divided by its largest value (in float64) before the contraction; that
factor cancels exactly in W / denom, so float64 agrees with JAX to
rounding and float32 stays finite.
"""

import ctypes

import torch

from .. import constants as const
from .. import cuda_build
from ..utils.clocks import count
from .source_sweep import RateGrids, SourceFields

# the neutral-density floor of the JAX function (evolve_point.F90:676-681)
DENSITY_FLOOR = 1.0e-30

# the kernel's band table: the constant bank holds MAX_BANDS rows
# (radiation/bands.py's 1 + 26 + 20 bands and one more), unrolled in
# groups of BAND_GROUP (csrc/photon_losses.cu: kMaxBands, kBandGroup);
# a padding row (1, 1, 1, 0, 0, 0) has a denominator of at least 3
# floors and weights 0, so it adds +0
MAX_BANDS = 48
BAND_GROUP = 8

# the scaled cross sections of each QuadTables in float64, (nb, 3), kept
# under the tables' identity (the entry holds them, so the id stays
# unique)
_SIGMA = {}


def neutral_densities(fields: SourceFields, floor=DENSITY_FLOOR):
    """(n, 3) neutral HI, HeI, HeII densities (cm^-3), floored."""
    nd = fields.ndens
    N = torch.stack([nd * fields.h_av0 * (1.0 - const.abu_he),
                     nd * fields.he_av0 * const.abu_he,
                     nd * fields.he_av1 * const.abu_he], dim=-1)
    return torch.clamp(N, min=floor)


def scaled_sigma_and_weights(tables, plb, n: int, vol_over_scale, dtype):
    """(sig (3, nb), W (nb, 3)) in `dtype`, built in float64: the
    band-averaged cross sections with the He band gates, divided by
    their largest value, and W[b, s] = L_b sig_s(b) / (n V)."""
    sig = _sigma64(tables)
    W = (plb.double()[:, None] * sig.T) / (n * float(vol_over_scale))
    return sig.to(dtype), W.to(dtype)


def _sigma64(tables) -> torch.Tensor:
    """(3, nb) float64: the band-averaged cross sections with the He band
    gates, divided by their largest value."""
    sig = torch.stack([tables.sigma_HI,
                       tables.sigma_HeI * tables.mask_HeI,
                       tables.sigma_HeII * tables.mask_HeII]).double()
    return sig / sig.max()


def _scaled_sigma(tables) -> torch.Tensor:
    """scaled_sigma_and_weights' sig in float64, transposed to (rows, 3)
    with rows the band count rounded up to a multiple of BAND_GROUP, the
    padding rows (1, 1, 1); built once per tables."""
    hit = _SIGMA.get(id(tables))
    if hit is None:
        sig_t = _sigma64(tables).T
        nb = sig_t.shape[0]
        rows = -(-nb // BAND_GROUP) * BAND_GROUP
        pad = torch.ones((rows, 3), dtype=torch.float64, device=sig_t.device)
        pad[:nb] = sig_t
        hit = _SIGMA[id(tables)] = (tables, pad)
    return hit[1]


def band_table(tables, plb, n: int, vol_over_scale, dtype) -> torch.Tensor:
    """The photon-loss kernel's (rows, 6) band table in `dtype`: row b
    is [sig_HI, sig_HeI, sig_HeII, W_HI, W_HeI, W_HeII] of band b, the
    values of scaled_sigma_and_weights (W built in float64 from the
    band escape `plb`), then padding rows (1, 1, 1, 0, 0, 0) up to a
    multiple of BAND_GROUP.  The kernel's entry packs the same table on
    the card (pack_kernel); this is its plain version.  The division by
    n V is IEEE's on every device: its divisor is a tensor on plb's
    device (PyTorch's CUDA division by a host scalar multiplies by the
    reciprocal).  Raises ValueError past MAX_BANDS bands."""
    nb = _band_count(plb)
    sig = _scaled_sigma(tables)
    w = torch.zeros_like(sig)
    nv = torch.tensor(n * float(vol_over_scale), dtype=torch.float64,
                      device=sig.device)
    w[:nb] = (plb.double()[:, None] * sig[:nb]) / nv
    return torch.cat([sig, w], dim=1).to(dtype)


def _band_count(plb) -> int:
    nb = plb.shape[0]
    if nb > MAX_BANDS:
        raise ValueError(f"the photon-loss kernel holds at most {MAX_BANDS} "
                         f"bands in its constant bank, not {nb}")
    return nb


def _check(rates: RateGrids):
    if rates.photon_loss_bands is None:
        raise ValueError(
            "rates carry no per-band photon loss: run the sweep with "
            "SweepConfig(track_band_loss=True)")


def distribute_photon_losses_plain(tables, rates: RateGrids,
                                   fields: SourceFields, vol_over_scale,
                                   floor: float = DENSITY_FLOOR
                                   ) -> RateGrids:
    """Plain PyTorch version of the photon-loss kernel: two matmuls and
    a reciprocal (`rates.photon_loss_bands` must be present)."""
    _check(rates)
    n = fields.ndens.shape[0]
    sig, W = scaled_sigma_and_weights(tables, rates.photon_loss_bands, n,
                                      vol_over_scale, fields.ndens.dtype)
    dphi = torch.reciprocal(neutral_densities(fields, floor) @ sig) @ W
    rates.phih.add_(dphi[:, 0])
    rates.phihe0.add_(dphi[:, 1])
    rates.phihe1.add_(dphi[:, 2])
    return rates


def distribute_photon_losses_cuda(tables, rates: RateGrids,
                                  fields: SourceFields, vol_over_scale,
                                  floor: float = DENSITY_FLOOR
                                  ) -> RateGrids:
    """The photon-loss kernel (``csrc/photon_losses.cu``); same contract
    as `distribute_photon_losses_plain`.

    Replaces photon_losses.py:distribute_photon_losses.  Memory-bound:
    one thread per cell reads 4 fields and adds into the 3 rate grids
    (one 16-byte load and store of the rate row when they are the
    sweep's (n, 4) rows), the band table (`band_table`, at most
    MAX_BANDS bands: more raise ValueError) in the constant bank, so
    neither (n, nb) intermediate of the matmul form is ever stored."""
    _launch(tables, rates, fields, vol_over_scale, floor)
    return rates


def _launch(tables, rates: RateGrids, fields: SourceFields, vol_over_scale,
            floor) -> torch.Tensor:
    """distribute_photon_losses_cuda's launch; returns the band table the
    entry packed on the card (what `band_table` computes)."""
    _check(rates)
    nd = fields.ndens
    dtype, device = nd.dtype, nd.device
    if not nd.is_cuda:
        raise ValueError("the photon-loss kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"photon-loss kernel takes float32/float64, not "
                        f"{dtype}")
    n = nd.shape[0]
    plb = rates.photon_loss_bands
    ins = [nd, fields.h_av0, fields.he_av0, fields.he_av1]
    outs = [rates.phih, rates.phihe0, rates.phihe1]
    for t in ins + outs + [plb]:
        if t.dtype != dtype or t.device != device:
            raise ValueError("fields and rates must share one dtype and "
                             "device")
    if any(t.shape != (n,) for t in ins + outs):
        raise ValueError(f"fields and rate grids must be ({n},)")
    ins = [t.contiguous() for t in ins]
    rstride = outs[0].stride(0)
    if any(t.stride(0) != rstride for t in outs):
        raise ValueError("phih, phihe0 and phihe1 must share one stride")
    if tables.sigma_HI.device != device:
        raise ValueError("the band tables must lie on the fields' device")
    nb = _band_count(plb)
    sig = _scaled_sigma(tables)
    tab = torch.empty((sig.shape[0], 6), dtype=dtype, device=device)

    lib = cuda_build.load("photon_losses")
    name = "photon_losses_" + ("f32" if dtype == torch.float32 else "f64")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_double,
                                            ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_longlong,
                                            ctypes.c_double]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    err = fn(*(P(t) for t in ins), P(plb.contiguous()), P(sig), nb,
             n * float(vol_over_scale), P(tab), tab.shape[0], n,
             float(floor), *(P(t) for t in outs), rstride,
             cuda_build.stream_of(nd))
    cuda_build.check(err, name)
    count("launches.photon_losses")
    return tab


def distribute_photon_losses(tables, rates: RateGrids, fields: SourceFields,
                             vol_over_scale,
                             floor: float = DENSITY_FLOOR) -> RateGrids:
    """Add the redistributed per-band photon losses to the rate grids, in
    place (c2ray_tpu/sweep/photon_losses.py:45).

    ``tables``: QuadTables; ``rates.photon_loss_bands`` must be present
    (sweep ran with ``track_band_loss=True``); ``vol_over_scale`` is the
    cell volume in the sweep's scaled flux units (dr^3 / flux_scale);
    ``floor`` clamps the neutral densities so fully ionized cells still
    absorb their share.  Only ionization rates are updated, as in the
    reference hook.  CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    device = fields.ndens.device
    if fields.ndens.is_cuda:
        fn = distribute_photon_losses_cuda
    elif device.type == "cpu":
        fn = distribute_photon_losses_plain
    else:
        raise ValueError(f"no photon-loss redistribution for device {device}")
    return fn(tables, rates, fields, vol_over_scale, floor)
