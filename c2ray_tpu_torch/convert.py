"""Carry tables and state across from the JAX package.

Each function takes one of ``c2ray_tpu``'s records with array leaves
(numpy arrays, or anything ``np.asarray`` accepts) and returns the
port's record, or the reverse.  Nothing here imports JAX: the tests use
these to feed both packages the same inputs.
"""

import numpy as np
import torch

from .cooling import CoolingTables
from .onedim.evolve import State1D
from .radiation.quadrature import QuadTables, SourceQuad
from .radiation.tables import RadiationTables, SourceTypeTables
from .state import GridState
from .sweep.source_sweep import RateGrids


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def quad_tables_from_numpy(qt, dtype=torch.float64, device=None
                           ) -> QuadTables:
    """The port's QuadTables from ``c2ray_tpu``'s (a fixed rule, or the
    "auto" rule's tuples of blocks)."""
    def source(sq):
        if sq is None:
            return None
        if isinstance(sq, tuple) and not hasattr(sq, "_fields"):
            return tuple(source(b) for b in sq)
        opt = lambda a: None if a is None else _tensor(a, dtype, device)
        return SourceQuad(
            band_lo=int(sq.band_lo), band_hi=int(sq.band_hi),
            sigma_hat=_tensor(sq.sigma_hat, dtype, device),
            A_photo=_tensor(sq.A_photo, dtype, device),
            A_heat_HI=opt(sq.A_heat_HI), A_heat_HeI=opt(sq.A_heat_HeI),
            A_heat_HeII=opt(sq.A_heat_HeII))

    arrays = {name: _tensor(getattr(qt, name), dtype, device)
              for name in QuadTables._fields
              if name not in ("bb", "pl", "qso")}
    return QuadTables(bb=source(qt.bb), pl=source(qt.pl),
                      qso=source(qt.qso), **arrays)


def cooling_tables_from_numpy(ct, dtype=torch.float64, device=None
                              ) -> CoolingTables:
    """The port's CoolingTables from ``c2ray_tpu``'s."""
    return CoolingTables(*(_tensor(a, dtype, device) for a in ct))


def grid_state_from_numpy(state, dtype=torch.float64, device=None
                          ) -> GridState:
    """The port's GridState from ``c2ray_tpu``'s."""
    return GridState(*(_tensor(a, dtype, device) for a in state))


def rate_grids_from_numpy(rates, dtype=torch.float64, device=None
                          ) -> RateGrids:
    """The port's RateGrids from ``c2ray_tpu``'s (photon_loss_bands
    stays None when the sweep did not track bands)."""
    return RateGrids(*(None if a is None else _tensor(a, dtype, device)
                       for a in rates))


def rate_grids_to_numpy(rates: RateGrids) -> RateGrids:
    """The port's RateGrids with float64 numpy leaves (None stays
    None)."""
    return RateGrids(*(None if a is None else
                       np.asarray(torch.as_tensor(a).detach().cpu(),
                                  dtype=np.float64) for a in rates))


def radiation_tables_from_numpy(rt, dtype=torch.float64, device=None
                                ) -> RadiationTables:
    """The port's RadiationTables (tau tables) from ``c2ray_tpu``'s; the
    heating columns become int64."""
    def source(st):
        if st is None:
            return None
        return SourceTypeTables(*(None if a is None else
                                  _tensor(a, dtype, device) for a in st))

    arrays = {name: (torch.tensor(np.asarray(getattr(rt, name)),
                                  dtype=torch.int64, device=device)
                     if name.startswith("hbin") else
                     _tensor(getattr(rt, name), dtype, device))
              for name in RadiationTables._fields
              if name not in ("bb", "pl", "qso")}
    return RadiationTables(bb=source(rt.bb), pl=source(rt.pl),
                           qso=source(rt.qso), **arrays)


def state1d_from_numpy(state, dtype=torch.float64, device=None) -> State1D:
    """The port's State1D from ``c2ray_tpu``'s."""
    return State1D(*(_tensor(a, dtype, device) for a in state))


def state1d_to_numpy(state: State1D) -> State1D:
    """The port's State1D with float64 numpy leaves."""
    return State1D(*(np.asarray(torch.as_tensor(a).detach().cpu(),
                                dtype=np.float64) for a in state))
