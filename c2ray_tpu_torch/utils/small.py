"""Small utility analogs: merge-rank sorting and unit-string parsing.

Port of ``c2ray_tpu/utils/small.py`` (numpy).

- `mrgrnk`: stable ranking (code/mrgrnk.f90, the public-domain Olagnon
  merge-sort ranking used by ctrper) -- numpy's stable argsort.
- `parse_length`: the 1D grid's unit-string handling
  (code/string.f90 convert_case + files_for_1D/grid.F90:73-102).
"""

import numpy as np

from .. import constants as const

_LENGTH_UNITS = {
    "cm": 1.0,
    "m": 100.0,
    "km": 1.0e5,
    "pc": const.pc,
    "kpc": const.kpc,
    "mpc": const.Mpc,
    "ly": 9.4607e17,
    "au": 1.49598e13,
}


def mrgrnk(values) -> np.ndarray:
    """Stable merge-sort ranking: rank[i] = index of the i-th smallest
    element (mrgrnk.f90 contract)."""
    return np.argsort(np.asarray(values), kind="stable")


def parse_length(value: float, unit: str) -> float:
    """Convert (value, unit string) to cm, case-insensitively
    (string.f90 convert_case; grid.F90:73-102)."""
    key = unit.strip().lower()
    if key not in _LENGTH_UNITS:
        raise ValueError(f"unknown length unit '{unit}' "
                         f"(known: {sorted(_LENGTH_UNITS)})")
    return value * _LENGTH_UNITS[key]
