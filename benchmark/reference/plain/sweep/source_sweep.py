"""Sweep configuration, field and rate records, and what the pyramid
sweep takes from them.

From ``c2ray_tpu/sweep/source_sweep.py`` (``do_source`` / ``evolve0D``,
evolve_source.F90:66-238, evolve_point.F90:79-319), cut to the
quadrature route with a fixed rule, the one the cells run.
"""

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from .. import constants as const
from ..radiation.quadrature import QuadTables, photoion_rates_quad

# evolve_point.F90:91 -- stop rate computation in fully shielded cells
MAX_COLDENSH = 2.0e29

# abundance weights per species column, order (HI, HeI, HeII)
_ABU = (1.0 - const.abu_he, const.abu_he, const.abu_he)


@dataclass(frozen=True)
class SweepConfig:
    """Static sweep configuration; `tables` are quadrature tables with a
    fixed rule (`QuadTables`)."""

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
    # shell engine: sources swept together per group (JAX's vmap width,
    # sweep_sources_accumulate's default batch_size); 0 = as the pyramid
    # and octant engines group them (`_source_group`)
    source_batch: int = 0
    # sources swept together per group (0 = auto: the group's column
    # cube and rate slab, S x M^3 x 7 values, under a fixed byte budget)
    source_chunk: int = 0
    # track the escaping-photon rate over the full band axis: the input
    # of the photon-loss redistribution (sweep/photon_losses.py;
    # pyramid engine only)
    track_band_loss: bool = False
    # the kernels' packed tables (`_kernel_tables`), made at the first
    # launch and kept for the next ones; a configuration made from this
    # one by dataclasses.replace shares them, keyed by the tables' identity
    kernel_cache: dict = field(default_factory=dict, compare=False,
                               repr=False)

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


def _cell_rates(cfg: SweepConfig, cd_in, cd_out, vol_ph, nflux, i_state,
                track_bands=False):
    """cd_in/cd_out: (..., 3) species columns; nflux: (..., 3) per
    source type (BB, PL, QSO), broadcast against the cells
    (JAX's source_sweep.py:118-135)."""
    kw = {"track_bands": True} if track_bands else {}
    return photoion_rates_quad(
        cfg.tables,
        cd_in[..., 0], cd_out[..., 0], cd_in[..., 1], cd_out[..., 1],
        cd_in[..., 2], cd_out[..., 2],
        vol_ph, i_state,
        nflux_bb=nflux[..., 0] if cfg.has_bb else None,
        nflux_pl=nflux[..., 1] if cfg.has_pl else None,
        nflux_qso=nflux[..., 2] if cfg.has_qso else None,
        do_heating=not cfg.isothermal,
        **kw,
    )


# ---- what the engines share


def stack_sweep_fields(cfg: SweepConfig, fields: SourceFields):
    """(M, M, M, 5) stacked field cube with the reference's epsilon
    clamps (evolve_point.F90:120-132)."""
    M = cfg.mesh
    eps = cfg.epsilon
    chans = [fields.ndens, torch.clamp(fields.h_av0, min=eps),
             torch.clamp(fields.h_av1, min=eps),
             torch.clamp(fields.he_av0, min=eps),
             torch.clamp(fields.he_av1, min=eps)]
    return torch.stack(chans, dim=-1).reshape(M, M, M, 5)


def _same_device(fstack, srcpos, nflux, cfg):
    for t in (srcpos, nflux, cfg.tables.sigma_HI):
        if t.device != fstack.device:
            raise ValueError(f"sources and tables must be on the fields' "
                             f"device {fstack.device}, not {t.device}")


def _scalars(cfg, dtype, device, dr, vol_over_scale):
    """dr and dr^3/flux_scale as tensors; the volume is computed on the
    host in float64 (the raw cube of a cm-scale dr overflows float32)."""
    if dr is None:
        dr, vol_over_scale = cfg.dr, cfg.vol / cfg.flux_scale
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return as_t(dr), as_t(vol_over_scale)
