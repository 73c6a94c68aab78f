"""Short-characteristics interpolation constants
(``code/files_for_3D/column_density.f90``,
``c2ray_tpu/sweep/cinterp.py:23-30``).

The shell engine's vectorised `cinterp_shell` is not ported yet; the
pyramid sweep uses only these constants.
"""

from .. import constants as const

SQRT2 = 1.4142135623730951
SQRT3 = 1.7320508075688772
# weightf clamp (column_density.f90:358,372)
MIN_WEIGHT_DENOM = 0.6

# species threshold cross sections, order (HI, HeI, HeII)
_SIGMAS = (const.sigma_HI_at_ion_freq, const.sigma_HeI_at_ion_freq,
           const.sigma_HeII_at_ion_freq)
