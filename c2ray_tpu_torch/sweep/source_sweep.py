"""Sweep configuration, field and rate records, and the per-cell rates.

Port of the parts of ``c2ray_tpu/sweep/source_sweep.py`` that the
pyramid sweep uses (``do_source`` / ``evolve0D``,
evolve_source.F90:66-238, evolve_point.F90:79-319).  The L1-shell
engine is not ported yet.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..radiation.quadrature import QuadTables, photoion_rates_quad

# evolve_point.F90:91 -- stop rate computation in fully shielded cells
MAX_COLDENSH = 2.0e29


@dataclass(frozen=True)
class SweepConfig:
    """Static sweep configuration."""

    tables: QuadTables
    mesh: int
    dr: float
    isothermal: bool = False
    epsilon: float = 1.0e-20
    max_coldensh: float = MAX_COLDENSH
    # homogeneous LLS opacity column per cell (type 1,
    # c2ray_parameters.f90:72-78); 0 disables
    coldensh_LLS: float = 0.0
    # tables were built divided by this (float32 range guard); the
    # sweep divides the shell volume by it so cell rates come out
    # physical
    flux_scale: float = 1.0
    has_bb: bool = True
    has_pl: bool = False
    has_qso: bool = False
    # sources swept together per group (0 = auto: the group's column
    # cube and rate slab, S x M^3 x 7 values, under a fixed byte budget)
    source_chunk: int = 0
    # track the escaping-photon rate over the full band axis: the input
    # of the photon-loss redistribution (sweep/photon_losses.py)
    track_band_loss: bool = False

    @property
    def vol(self) -> float:
        return self.dr**3


class SourceFields(NamedTuple):
    """Flattened (mesh^3,) grid fields the sweep reads."""

    ndens: torch.Tensor
    h_av0: torch.Tensor
    h_av1: torch.Tensor
    he_av0: torch.Tensor
    he_av1: torch.Tensor


class RateGrids(NamedTuple):
    """Flattened (mesh^3,) accumulated rate grids (evolve_data.F90:40-49)
    and the iteration's photon and LLS losses (0-d tensors)."""

    phih: torch.Tensor
    phihe0: torch.Tensor
    phihe1: torch.Tensor
    phiheat: torch.Tensor
    photon_loss: torch.Tensor
    lls_loss: torch.Tensor
    # (nbands,) escaping-photon rate per band when the sweep ran with
    # track_band_loss, else None
    photon_loss_bands: Optional[torch.Tensor] = None


def zero_rate_grids(mesh: int, dtype, device=None) -> RateGrids:
    z = torch.zeros(mesh**3, dtype=dtype, device=device)
    s = torch.zeros((), dtype=dtype, device=device)
    return RateGrids(phih=z, phihe0=z, phihe1=z, phiheat=z,
                     photon_loss=s, lls_loss=s)


def _cell_rates(cfg: SweepConfig, cd_in, cd_out, vol_ph, nflux, i_state,
                track_bands=False):
    """cd_in/cd_out: (..., 3) species columns; nflux: (..., 3) per
    source type (BB, PL, QSO), broadcast against the cells."""
    return photoion_rates_quad(
        cfg.tables,
        cd_in[..., 0], cd_out[..., 0], cd_in[..., 1], cd_out[..., 1],
        cd_in[..., 2], cd_out[..., 2],
        vol_ph, i_state,
        nflux_bb=nflux[..., 0] if cfg.has_bb else None,
        nflux_pl=nflux[..., 1] if cfg.has_pl else None,
        nflux_qso=nflux[..., 2] if cfg.has_qso else None,
        do_heating=not cfg.isothermal,
        track_bands=track_bands,
    )
