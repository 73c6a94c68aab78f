"""Usable band ranges per source type (``code/radiation_tables.f90``).

Only the band-limit helpers of ``c2ray_tpu/radiation/tables.py`` are
ported: the quadrature tables need them.  The tau-indexed rate tables
belong to the parity path and are not ported yet.
"""

from .bands import Bands


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
