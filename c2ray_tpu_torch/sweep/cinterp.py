"""Vectorised short-characteristics column-density interpolation.

Port of ``c2ray_tpu/sweep/cinterp.py`` (``cinterp`` + ``weightf``,
``code/files_for_3D/column_density.f90:28-376``) for a whole wavefront
shell at once: the dominant axis is chosen per cell (z wins ties, then
y), the other two axes form a canonical (u, v) pair, and the four
corners are read through the periodic wrap in absolute coordinates,
each as one gather of the three species' columns.  The pyramid and
octant sweeps use the constants only.
"""

from typing import Tuple

import torch

from .. import constants as const

SQRT2 = 1.4142135623730951
SQRT3 = 1.7320508075688772
# weightf clamp (column_density.f90:358,372)
MIN_WEIGHT_DENOM = 0.6

# species threshold cross sections, order (HI, HeI, HeII)
_SIGMAS = (const.sigma_HI_at_ion_freq, const.sigma_HeI_at_ion_freq,
           const.sigma_HeII_at_ion_freq)


def _fsign(x):
    """Fortran sign(1, x): +1 for x >= 0 else -1."""
    return torch.where(x >= 0, 1, -1)


def cinterp_shell(offsets, srcpos, mesh: int,
                  cd_all) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incoming column densities + path length for a shell of cells.

    offsets: (N, 3) int (di, dj, dk) from the source; srcpos: (3,) int
    source cell (0-based), or (S, 3) for S sources at once; cd_all:
    (mesh^3, 3) outgoing columns (HI, HeI, HeII), or (S, mesh^3, 3).
    Returns (cdensi (N, 3) or (S, N, 3), path (N,) in cell units).
    """
    dtype = cd_all.dtype
    d = offsets.to(dtype=torch.long)                      # (N, 3)
    da = d.abs()
    idela, jdela, kdela = da[:, 0], da[:, 1], da[:, 2]

    # branch order of the reference (column_density.f90:107,199,275):
    # z wins ties, then y, then x
    is_z = (kdela >= jdela) & (kdela >= idela)
    is_y = (~is_z) & (jdela >= idela) & (jdela >= kdela)
    dom = torch.where(is_z, 2, torch.where(is_y, 1, 0))  # (N,)

    # canonical (u, v) = remaining axes in ascending order
    u_ax = torch.where(dom == 0, 1, 0)
    v_ax = torch.where(dom == 2, 1, 2)

    def take(p, ax):
        """p[..., n, ax[n]] for p of shape (..., N, 3)."""
        return p.gather(-1, ax.expand(p.shape[:-1])[..., None])[..., 0]

    d_dom, d_u, d_v = take(d, dom), take(d, u_ax), take(d, v_ax)
    sgn_dom, sgn_u, sgn_v = _fsign(d_dom), _fsign(d_u), _fsign(d_v)
    fd_dom, fd_u, fd_v = d_dom.to(dtype), d_u.to(dtype), d_v.to(dtype)

    # crossing point on the dominant-axis cell face
    # alam = (d_dom - sgn*0.5)/d_dom   (column_density.f90:111)
    alam = (fd_dom - 0.5 * sgn_dom.to(dtype)) / fd_dom
    # fractional distances to the u/v "minus" corners
    du = 2.0 * torch.abs(alam * fd_u - (fd_u - 0.5 * sgn_u.to(dtype)))
    dv = 2.0 * torch.abs(alam * fd_v - (fd_v - 0.5 * sgn_v.to(dtype)))

    # bilinear weights for corners (u_m,v_m),(u,v_m),(u_m,v),(u,v)
    # (column_density.f90:119-122)
    s1 = (1.0 - du) * (1.0 - dv)
    s2 = du * (1.0 - dv)
    s3 = (1.0 - du) * dv
    s4 = du * dv

    batched = srcpos.dim() == 2
    sp = srcpos.to(dtype=torch.long)
    pos = torch.remainder((sp[:, None, :] if batched else sp[None, :]) + d,
                          mesh)                       # (N, 3) or (S, N, 3)

    def corner_flat(u_minus: bool, v_minus: bool):
        cd_ = take(pos, dom) - sgn_dom
        cu = take(pos, u_ax) - (sgn_u if u_minus else 0)
        cv = take(pos, v_ax) - (sgn_v if v_minus else 0)
        cd_ = torch.remainder(cd_, mesh)
        cu = torch.remainder(cu, mesh)
        cv = torch.remainder(cv, mesh)
        cx = torch.where(dom == 0, cd_, torch.where(u_ax == 0, cu, cv))
        cy = torch.where(dom == 1, cd_, torch.where(u_ax == 1, cu, cv))
        cz = torch.where(dom == 2, cd_, torch.where(v_ax == 2, cv, cu))
        return (cx * mesh + cy) * mesh + cz

    def gather(flat):
        if batched:
            return cd_all[torch.arange(cd_all.shape[0],
                                       device=cd_all.device)[:, None], flat]
        return cd_all[flat]

    # one (..., N, 3) gather per corner
    c1 = gather(corner_flat(True, True))
    c2 = gather(corner_flat(False, True))
    c3 = gather(corner_flat(True, False))
    c4 = gather(corner_flat(False, False))

    sig = torch.tensor(_SIGMAS, dtype=dtype, device=cd_all.device)

    def w(s_geo, c):
        return s_geo[:, None] / torch.clamp(c * sig, min=MIN_WEIGHT_DENOM)

    w1, w2, w3, w4 = w(s1, c1), w(s2, c2), w(s3, c3), w(s4, c4)
    wsum = w1 + w2 + w3 + w4
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / wsum

    # diagonal boost (column_density.f90:174-184)
    d_dom_a, d_u_a, d_v_a = d_dom.abs(), d_u.abs(), d_v.abs()
    on_diag = (d_dom_a == 1) & ((d_u_a == 1) | (d_v_a == 1))
    full_diag = (d_u_a == 1) & (d_v_a == 1)
    diag_boost = torch.ones(d.shape[0], dtype=dtype, device=cd_all.device)
    diag_boost[on_diag] = SQRT2
    diag_boost[on_diag & full_diag] = SQRT3
    cdensi = cdensi * diag_boost[:, None]

    # path length through the cell (column_density.f90:194,269,341)
    path = torch.sqrt((fd_u * fd_u + fd_v * fd_v) / (fd_dom * fd_dom) + 1.0)

    return cdensi, path
