"""What the quadrature rates share with the reference's rate routine.

From ``c2ray_tpu/radiation/photo.py``
(``code/radiation_photoionrates.f90:108-823``): the `PhotRates` record,
the optically-thin thresholds and the Ricotti et al. 2002
secondary-ionization coefficients (radiation_photoionrates.f90:49-56).
"""

from typing import NamedTuple

import torch

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
