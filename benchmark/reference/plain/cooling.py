"""Radiative cooling: per-species cooling curves + table lookup.

Port of ``c2ray_tpu/cooling.py`` (``code/cooling_h.f90``).  The five
801-point tables (H0, H1, He0, He1, He2 over log10 T in [1, 9]) are
built in float64 numpy from the published fits, exactly as the JAX
package builds them, or read from the reference's ASCII files.

`coolin` is the plain version of the lookup that the chemistry kernel's
thermal sub-cycle (``csrc/chemistry.cu``) runs per cell: linear
interpolation in log10 T with a truncating integer cast, the row index
clipped to [0, 799] and the fraction left signed, so temperatures below
10 K and above 1e9 K extrapolate from the end rows as in JAX.  The
TPU's two-hot matmul form of the same interpolation is not ported.
"""

import os
from typing import NamedTuple

import numpy as np
import torch

from . import constants as const

TEMPPOINTS = 801
MINTEMP_LOG = 1.0
MAXTEMP_LOG = 9.0
DTEMP_LOG = (MAXTEMP_LOG - MINTEMP_LOG) / (TEMPPOINTS - 1)


class CoolingTables(NamedTuple):
    """Λ(T) per species [erg cm^3 / s], linear values, shape (801,)."""

    h0: torch.Tensor   # cooling per neutral-H fraction (collisional exc+ion)
    h1: torch.Tensor   # cooling per ionized-H fraction (recomb B + ff)
    he0: torch.Tensor
    he1: torch.Tensor
    he2: torch.Tensor


def _gff(T, Zeff=1.0):
    """Free-free Gaunt factor (Hui & Gnedin 1997 eq. therein)."""
    logt = np.log10(T / Zeff**2)
    return np.where(T < 3.2e5 * Zeff**2,
                    0.79464 + 0.1243 * logt,
                    2.13164 - 0.1240 * logt)


def _build_tables_np():
    """Per-species cooling curves Λ_s(T) [erg cm^3/s] such that the total
    cooling is  n * ne * (Σ_s x_s Λ_s(T) * abundance_s)  -- the same
    contract as the reference tables (cooling_h.f90:59-69)."""
    T = 10.0 ** np.linspace(MINTEMP_LOG, MAXTEMP_LOG, TEMPPOINTS)
    kT_erg = const.k_B * T
    sqT5 = 1.0 + np.sqrt(T / 1e5)

    # --- collisional excitation cooling (Cen 1992 fits)
    ce_HI = 7.5e-19 / sqT5 * np.exp(-118348.0 / T)          # ~ n_e n_H0
    ce_HeII = 5.54e-17 * T**-0.397 / sqT5 * np.exp(-473638.0 / T)  # ~ n_e n_He+

    # --- collisional ionization cooling: Hui & Gnedin (1997) rate fits
    #     times the ionization energy (cooling_h.f90:115-117)
    def hg_ci(TthK, A, p, x0, a, b):
        lam = 2.0 * TthK / T
        return (A * T**-1.5 * np.exp(-TthK / T) * lam**p
                / (1.0 + (lam / x0) ** a) ** b)

    ci_HI = hg_ci(const.temph0, 21.11, -1.089, 0.354, 0.874, 1.101) \
        * const.hionen
    ci_HeI = hg_ci(const.temphe[0], 32.38, -1.146, 0.416, 0.987, 1.056) \
        * const.heionen[0]

    # --- recombination cooling, Hui & Gnedin (1997) case-B fits
    lamH = 2.0 * const.temph0 / T
    rec_H1 = (3.435e-30 * T * lamH**1.970
              / (1.0 + (lamH / 2.25) ** 0.376) ** 3.720)
    lamHe1 = 2.0 * const.temphe[0] / T
    # HG97 give the HeII case-B recombination cooling as kT * 1.26e-14 lam^0.75
    rec_He1 = 1.26e-14 * kT_erg * lamHe1**0.75
    # He++ case B: hydrogenic scaling L_Z(T) = Z^3 L_H(T/Z^2); note
    # lam_H(T/4) == lam_HeIII(T), so this is 8 x the H fit at T/4.
    lamHe2 = 2.0 * const.temphe[1] / T
    rec_He2 = (8.0 * 3.435e-30 * (T / 4.0) * lamHe2**1.970
               / (1.0 + (lamHe2 / 2.25) ** 0.376) ** 3.720)

    # --- dielectronic recombination cooling of He+ (Black 1981 / Cen 1992)
    dielec_He1 = (1.24e-13 * T**-1.5 * np.exp(-470000.0 / T)
                  * (1.0 + 0.3 * np.exp(-94000.0 / T)))

    # --- free-free (Gaunt-factor bremsstrahlung)
    ff_1 = 1.426e-27 * np.sqrt(T) * _gff(T, 1.0)        # Z=1: H+, He+
    ff_2 = 1.426e-27 * np.sqrt(T) * 4.0 * _gff(T, 2.0)  # Z=2: He++

    h0 = ce_HI + ci_HI
    h1 = rec_H1 + ff_1
    # He0 table: collisional ionization only (cooling_h.f90:113-117)
    he0 = ci_HeI
    # He1 table: excitation + recombination B + dielectronic + ff, but NO
    # collisional ionization (cooling_h.f90:130-136, "nocollion")
    he1 = ce_HeII + rec_He1 + dielec_He1 + ff_1
    # He2 table: recombination + ff
    he2 = rec_He2 + ff_2

    floor = 1e-50
    return tuple(np.maximum(x, floor) for x in (h0, h1, he0, he1, he2))


def _tables(vals, dtype, device) -> CoolingTables:
    return CoolingTables(*(torch.as_tensor(np.asarray(v, dtype=np.float64),
                                           dtype=dtype, device=device)
                           for v in vals))


def setup_cooling_tables(dtype=torch.float64, device=None) -> CoolingTables:
    """Build the five cooling tables (the `setup_cool` analog,
    cooling_h.f90:76-171) in float64 and cast once."""
    return _tables(_build_tables_np(), dtype, device)


def stacked(tables: CoolingTables) -> torch.Tensor:
    """The (801, 5) table, species last: the layout the chemistry kernel
    reads (row = temperature point)."""
    return torch.stack(tuple(tables), dim=-1)


def coolin(tables: CoolingTables, nucldens, eldens, xh0, xh1, xhe0, xhe1,
           xhe2, temperature):
    """Cooling rate [erg cm^-3 s^-1] (cooling_h.f90:40-71), elementwise
    over the cells (the gather path of the JAX package's coolin)."""
    tab5 = stacked(tables)                                  # (801, 5)
    tpos = (torch.log10(temperature) - MINTEMP_LOG) / DTEMP_LOG
    itpos = torch.clamp(tpos.to(torch.int32), 0, TEMPPOINTS - 2).long()
    dtpos = tpos - itpos.to(tpos.dtype)
    lo = tab5[itpos]
    lam = lo + (tab5[itpos + 1] - lo) * dtpos[..., None]
    x5 = torch.stack([xh0 * (1.0 - const.abu_he),
                      xh1 * (1.0 - const.abu_he),
                      xhe0 * const.abu_he,
                      xhe1 * const.abu_he,
                      xhe2 * const.abu_he], dim=-1)
    return nucldens * eldens * torch.sum(lam * x5, dim=-1)


def load_ascii_cooling_table(path):
    """Read one reference-format ASCII cooling table
    (cooling_h.f90:83-160): a 3-int header line followed by 801 rows of
    (log10 T, log10 Lambda).  Returns linear Lambda(T) on the module's
    801-point log-T grid (values -50 mean 'zero')."""
    rows = np.loadtxt(path, skiprows=1)
    if rows.shape[0] != TEMPPOINTS:
        raise ValueError(
            f"{path}: expected {TEMPPOINTS} rows, got {rows.shape[0]}")
    logt = rows[:, 0]
    if not np.allclose(logt[0], MINTEMP_LOG) or not np.allclose(
            logt[-1], MAXTEMP_LOG):
        raise ValueError(f"{path}: unexpected log-T grid "
                         f"[{logt[0]}, {logt[-1]}]")
    return 10.0 ** rows[:, 1]


def setup_cooling_tables_from_files(table_dir, dtype=torch.float64,
                                    filenames=("H0-cool.tab",
                                               "H1-cool-B.tab",
                                               "He0-cool_new.tab",
                                               "He1-cool_new_nocollion.tab",
                                               "He2-cool.tab"),
                                    device=None) -> CoolingTables:
    """Build CoolingTables from the reference's ASCII files (the exact
    set the current Makefiles link, cooling_h.f90:25-33)."""
    return _tables([load_ascii_cooling_table(os.path.join(table_dir, f))
                    for f in filenames], dtype, device)
