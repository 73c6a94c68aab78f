"""3D grid state: densities, ionization fractions, temperatures.

Port of ``c2ray_tpu/state.py``: one `GridState` record of flattened
(mesh^3,) tensors, in the JAX package's layout.  Updates return a new
record; the tensors they do not replace are shared, not copied.

Temperature slots follow mat_ini_test.F90:469-515: t_inter (slot 0,
latest iterate), t_av (slot 1, time-averaged), t_final (slot 2,
start-of-timestep / converged value).
"""

from typing import NamedTuple

import torch

from .chemistry import IonFractions, IonState


class GridState(NamedTuple):
    """All per-cell state, flattened to (mesh^3,)."""

    ndens: torch.Tensor
    # start-of-timestep fractions (the reference's xh / xhe)
    h0: torch.Tensor
    h1: torch.Tensor
    he0: torch.Tensor
    he1: torch.Tensor
    he2: torch.Tensor
    # time-averaged fractions (xh_av / xhe_av)
    h_av0: torch.Tensor
    h_av1: torch.Tensor
    he_av0: torch.Tensor
    he_av1: torch.Tensor
    he_av2: torch.Tensor
    # intermediate (current iterate) fractions (xh_intermed / xhe_intermed)
    h_int0: torch.Tensor
    h_int1: torch.Tensor
    he_int0: torch.Tensor
    he_int1: torch.Tensor
    he_int2: torch.Tensor
    # temperatures
    t_inter: torch.Tensor
    t_av: torch.Tensor
    t_final: torch.Tensor
    # clumping: 0-d (uniform) or (mesh^3,)
    clumping: torch.Tensor

    @property
    def mesh3(self) -> int:
        return self.ndens.shape[0]

    def ion_state(self, epsilon=1.0e-20) -> IonState:
        """IonState view with the reference's max(eps, .) clamps
        (evolve_point.F90:368-378)."""
        c = lambda x: torch.clamp(x, min=epsilon)
        return IonState(
            cur=IonFractions(c(self.h_int0), c(self.h_int1), c(self.he_int0),
                             c(self.he_int1), c(self.he_int2)),
            avg=IonFractions(c(self.h_av0), c(self.h_av1), c(self.he_av0),
                             c(self.he_av1), c(self.he_av2)),
            old=IonFractions(c(self.h0), c(self.h1), c(self.he0),
                             c(self.he1), c(self.he2)),
        )


def initial_grid_state(ndens, xh1, xhe1, xhe2, temperature, clumping=1.0,
                       dtype=torch.float64, device=None) -> GridState:
    """Build a GridState from physical fields (numpy arrays, tensors or
    scalars; any shape, flattened) on `device` in `dtype`."""
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device).reshape(-1)
    nd = f(ndens)
    n = nd.shape[0]

    def b(a):
        t = f(a)
        return t.expand(n).contiguous() if t.numel() == 1 else t

    h1 = b(xh1)
    he1 = b(xhe1)
    he2 = b(xhe2)
    t = b(temperature)
    h0 = 1.0 - h1
    he0 = 1.0 - he1 - he2
    cl = torch.as_tensor(clumping, dtype=dtype, device=device)
    if cl.ndim > 0:
        cl = cl.reshape(-1)
    return GridState(
        ndens=nd,
        h0=h0, h1=h1, he0=he0, he1=he1, he2=he2,
        h_av0=h0, h_av1=h1, he_av0=he0, he_av1=he1, he_av2=he2,
        h_int0=h0, h_int1=h1, he_int0=he0, he_int1=he1, he_int2=he2,
        t_inter=t, t_av=t, t_final=t,
        clumping=cl,
    )


def begin_timestep(state: GridState) -> GridState:
    """Initialize av/intermed to the start-of-step values
    (evolve.F90:130-141)."""
    return state._replace(
        h_av0=state.h0, h_av1=state.h1,
        he_av0=state.he0, he_av1=state.he1, he_av2=state.he2,
        h_int0=state.h0, h_int1=state.h1,
        he_int0=state.he0, he_int1=state.he1, he_int2=state.he2,
    )


def finish_timestep(state: GridState) -> GridState:
    """On convergence, promote intermed -> committed and the final
    temperature (evolve.F90:163-166, set_final_temperature_point)."""
    return state._replace(
        h0=state.h_int0, h1=state.h_int1,
        he0=state.he_int0, he1=state.he_int1, he2=state.he_int2,
        t_final=state.t_inter,
    )
