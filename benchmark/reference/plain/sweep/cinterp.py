"""The constants of the short-characteristics column-density
interpolation (``c2ray_tpu/sweep/cinterp.py``, ``cinterp`` + ``weightf``,
``code/files_for_3D/column_density.f90:28-376``) that the pyramid sweep
uses.
"""

from .. import constants as const

SQRT2 = 1.4142135623730951
SQRT3 = 1.7320508075688772
# weightf clamp (column_density.f90:358,372)
MIN_WEIGHT_DENOM = 0.6

# species threshold cross sections, order (HI, HeI, HeII)
_SIGMAS = (const.sigma_HI_at_ion_freq, const.sigma_HeI_at_ion_freq,
           const.sigma_HeII_at_ion_freq)
