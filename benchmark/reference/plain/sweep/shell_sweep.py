"""The L1-shell short-characteristics sweep, for the general extents (an
odd mesh, a max_subbox below M/2 - 1).

From ``c2ray_tpu/sweep/geometry.py`` (``build_shell_table``),
``c2ray_tpu/sweep/cinterp.py`` (``cinterp_shell``) and
``c2ray_tpu/sweep/source_sweep.py`` (``_sweep_one_source_stacked`` under
the source vmap), evolve_source.F90:103-109 and evolve_point.F90:79-319.
All cells with |di|+|dj|+|dk| = s are mutually independent and depend
only on shells <= s-1, so each shell is one batch.  Unlike the JAX
package's, `shell_plain` takes the step's cell size and per-cell LLS
column, as the pyramid sweep (`pyramid_sweep.trace_plain`) does: the
reference of a cosmological step, whose cell size and LLS column change
every step (cosmology.f90:159-202).
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as const
from .cinterp import MIN_WEIGHT_DENOM, SQRT2, SQRT3, _SIGMAS
from .source_sweep import _ABU, SweepConfig, _cell_rates, _same_device, _scalars


@dataclass(frozen=True, eq=False)
class ShellTable:
    """The cells of a trace extent sorted by shell: `cells` (n, 3) int
    offsets from the source, `boundary` (n,) whether a cell lies on the
    trace volume's boundary (evolve_point.F90:310-315), `starts`
    (n_shells + 1,) where each shell begins; `lo`, `hi` the per-axis
    extents (inclusive)."""

    cells: np.ndarray
    boundary: np.ndarray
    starts: np.ndarray
    lo: tuple
    hi: tuple

    @property
    def n_shells(self) -> int:
        return len(self.starts) - 1


def build_shell_table(mesh: int, max_radius: int = None) -> ShellTable:
    """The shells of a cubic mesh's trace extent: left M/2 - 1, right
    M/2 (evolve_source.F90:103-109; odd M: (M-1)/2 both ways), each cut
    to `max_radius` (the reference's max_subbox wall,
    c2ray_parameters.f90:52-56)."""
    half_r = mesh // 2
    half_l = half_r - 1 + mesh % 2
    if max_radius is not None:
        half_r = min(half_r, max_radius)
        half_l = min(half_l, max_radius)
    lo = (-half_l,) * 3
    hi = (half_r,) * 3
    r = np.arange(-half_l, half_r + 1)
    di, dj, dk = (x.ravel() for x in np.meshgrid(r, r, r, indexing="ij"))
    s = np.abs(di) + np.abs(dj) + np.abs(dk)
    keep = s > 0  # the source cell is handled on its own
    di, dj, dk, s = di[keep], dj[keep], dk[keep], s[keep]
    on_bound = ((di == -half_l) | (di == half_r) | (dj == -half_l)
                | (dj == half_r) | (dk == -half_l) | (dk == half_r))
    order = np.argsort(s, kind="stable")
    cells = np.stack([di, dj, dk], axis=1)[order].astype(np.int64)
    counts = np.bincount(s, minlength=int(s.max()) + 1)[1:]
    starts = np.concatenate([[0], np.cumsum(counts)])
    return ShellTable(cells=cells, boundary=on_bound[order], starts=starts,
                      lo=lo, hi=hi)


def _fsign(x):
    """Fortran sign(1, x): +1 for x >= 0 else -1."""
    return torch.where(x >= 0, 1, -1)


def cinterp_shell(offsets, srcpos, mesh: int, cd_all):
    """Incoming column densities and path length for a shell of cells
    (cinterp + weightf, column_density.f90:28-376).

    offsets: (N, 3) int (di, dj, dk) from the source; srcpos: (S, 3)
    int source cells; cd_all: (S, mesh^3, 3) outgoing columns (HI, HeI,
    HeII).  Returns (cdensi (S, N, 3), path (N,) in cell units)."""
    dtype = cd_all.dtype
    d = offsets.to(dtype=torch.long)
    da = d.abs()
    idela, jdela, kdela = da[:, 0], da[:, 1], da[:, 2]
    # branch order of the reference (column_density.f90:107,199,275):
    # z wins ties, then y, then x
    is_z = (kdela >= jdela) & (kdela >= idela)
    is_y = (~is_z) & (jdela >= idela) & (jdela >= kdela)
    dom = torch.where(is_z, 2, torch.where(is_y, 1, 0))
    # canonical (u, v) = remaining axes in ascending order
    u_ax = torch.where(dom == 0, 1, 0)
    v_ax = torch.where(dom == 2, 1, 2)

    def take(p, ax):
        return p.gather(-1, ax.expand(p.shape[:-1])[..., None])[..., 0]

    d_dom, d_u, d_v = take(d, dom), take(d, u_ax), take(d, v_ax)
    sgn_dom, sgn_u, sgn_v = _fsign(d_dom), _fsign(d_u), _fsign(d_v)
    fd_dom, fd_u, fd_v = d_dom.to(dtype), d_u.to(dtype), d_v.to(dtype)
    # the crossing point on the dominant-axis cell face
    # (column_density.f90:111)
    alam = (fd_dom - 0.5 * sgn_dom.to(dtype)) / fd_dom
    du = 2.0 * torch.abs(alam * fd_u - (fd_u - 0.5 * sgn_u.to(dtype)))
    dv = 2.0 * torch.abs(alam * fd_v - (fd_v - 0.5 * sgn_v.to(dtype)))
    # bilinear weights (column_density.f90:119-122)
    s1 = (1.0 - du) * (1.0 - dv)
    s2 = du * (1.0 - dv)
    s3 = (1.0 - du) * dv
    s4 = du * dv

    sp = srcpos.to(dtype=torch.long)
    pos = torch.remainder(sp[:, None, :] + d, mesh)           # (S, N, 3)

    def corner_flat(u_minus: bool, v_minus: bool):
        cd_ = torch.remainder(take(pos, dom) - sgn_dom, mesh)
        cu = torch.remainder(take(pos, u_ax) - (sgn_u if u_minus else 0),
                             mesh)
        cv = torch.remainder(take(pos, v_ax) - (sgn_v if v_minus else 0),
                             mesh)
        cx = torch.where(dom == 0, cd_, torch.where(u_ax == 0, cu, cv))
        cy = torch.where(dom == 1, cd_, torch.where(u_ax == 1, cu, cv))
        cz = torch.where(dom == 2, cd_, torch.where(v_ax == 2, cv, cu))
        return (cx * mesh + cy) * mesh + cz

    rows = torch.arange(cd_all.shape[0], device=cd_all.device)[:, None]
    c1 = cd_all[rows, corner_flat(True, True)]
    c2 = cd_all[rows, corner_flat(False, True)]
    c3 = cd_all[rows, corner_flat(True, False)]
    c4 = cd_all[rows, corner_flat(False, False)]
    sig = torch.tensor(_SIGMAS, dtype=dtype, device=cd_all.device)

    def w(s_geo, c):
        return s_geo[:, None] / torch.clamp(c * sig, min=MIN_WEIGHT_DENOM)

    w1, w2, w3, w4 = w(s1, c1), w(s2, c2), w(s3, c3), w(s4, c4)
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
    # the diagonal boost (column_density.f90:174-184)
    d_dom_a, d_u_a, d_v_a = d_dom.abs(), d_u.abs(), d_v.abs()
    on_diag = (d_dom_a == 1) & ((d_u_a == 1) | (d_v_a == 1))
    full_diag = (d_u_a == 1) & (d_v_a == 1)
    boost = torch.ones(d.shape[0], dtype=dtype, device=cd_all.device)
    boost[on_diag] = SQRT2
    boost[on_diag & full_diag] = SQRT3
    cdensi = cdensi * boost[:, None]
    # the path length through the cell (column_density.f90:194,269,341)
    path = torch.sqrt((fd_u * fd_u + fd_v * fd_v) / (fd_dom * fd_dom) + 1.0)
    return cdensi, path


def shell_plain(cfg: SweepConfig, table: ShellTable, fstack, srcpos, nflux,
                dr=None, vol_over_scale=None, lls=None):
    """The shell sweep of S sources.

    fstack: (M, M, M, 5) stacked fields; srcpos: (S, 3) int; nflux:
    (S, 3); `dr` and `vol_over_scale` the step's cell size and
    dr^3/flux_scale (cfg's when None); `lls` (M^3,) the per-cell LLS
    column, in place of cfg.coldensh_LLS.  Returns (slab (S, M^3, 4)
    per-source rates in absolute coordinates, photon_loss (S,),
    lls_loss (S,))."""
    _same_device(fstack, srcpos, nflux, cfg)
    M = fstack.shape[0]
    n = M**3
    S = srcpos.shape[0]
    dtype, device = fstack.dtype, fstack.device
    dr, vos = _scalars(cfg, dtype, device, dr, vol_over_scale)
    abu = torch.tensor(_ABU, dtype=dtype, device=device)
    f = fstack.reshape(n, 5)
    sp = srcpos.to(dtype=torch.long)
    nfl = nflux.to(dtype=dtype)
    s_idx = torch.arange(S, device=device)
    lls_cells = None if lls is None else lls.reshape(-1)

    cd = torch.zeros((S, n, 3), dtype=dtype, device=device)
    slab = torch.zeros((S, n, 4), dtype=dtype, device=device)
    ploss = torch.zeros(S, dtype=dtype, device=device)
    lloss = torch.zeros(S, dtype=dtype, device=device)

    def flat_of(pos):
        return (pos[..., 0] * M + pos[..., 1]) * M + pos[..., 2]

    def base_cols(fc):
        return (torch.stack([fc[..., 1], fc[..., 3], fc[..., 4]], dim=-1)
                * fc[..., 0:1] * abu)

    # the source cell (evolve_point.F90:140-151): vol_ph = cell volume
    flat0 = flat_of(torch.remainder(sp, M))
    f0 = f[flat0]
    bc0 = base_cols(f0)
    cc0 = bc0 * (0.5 * dr)
    cd[s_idx, flat0] = cc0
    phi0 = _cell_rates(cfg, torch.zeros_like(cc0), cc0, vos, nfl, f0[:, 2])
    slab[s_idx, flat0] = torch.stack(
        [phi0.photo_cell_HI / bc0[:, 0], phi0.photo_cell_HeI / bc0[:, 1],
         phi0.photo_cell_HeII / bc0[:, 2], phi0.heat], dim=-1)

    cells = torch.as_tensor(table.cells, device=device)
    bound = torch.as_tensor(table.boundary, device=device)
    starts = table.starts
    nfl_cells = nfl[:, None, :]
    for k in range(table.n_shells):
        offs = cells[starts[k]:starts[k + 1]]                 # (W, 3)
        on_bound = bound[starts[k]:starts[k + 1]]
        cd_in, path_units = cinterp_shell(offs, sp, M, cd)    # (S, W, 3)
        path = path_units * dr
        flat = flat_of(torch.remainder(sp[:, None, :] + offs, M))  # (S, W)
        o = offs.to(dtype)
        dist2 = o[:, 0] ** 2 + o[:, 1] ** 2 + o[:, 2] ** 2
        vol_ratio = 4.0 * const.pi * dist2 * path_units
        # the LLS column of the cell being entered adds to the incoming
        # HI column (evolve_point.F90:177-180), or the homogeneous one
        if lls_cells is not None:
            lls_add = lls_cells[flat] * path_units
        elif cfg.coldensh_LLS > 0.0:
            lls_add = cfg.coldensh_LLS * path_units
        else:
            lls_add = None
        if lls_add is not None:
            cd_in[..., 0] += lls_add
        fc = f[flat]                                          # (S, W, 5)
        bcols = base_cols(fc)
        # outgoing columns = in + the time-averaged cell column
        # (evolve_point.F90:237-244)
        cd_out = cd_in + bcols * path[:, None]
        cd[s_idx[:, None], flat] = cd_out
        phi = _cell_rates(cfg, cd_in, cd_out, vol_ratio * vos, nfl_cells,
                          fc[..., 2])
        # shielded cells get zero rates (evolve_point.F90:250,279-290)
        live = cd_in[..., 0] < cfg.max_coldensh
        fl = live.to(dtype)
        slab[s_idx[:, None], flat] = torch.stack(
            [fl * phi.photo_cell_HI / bcols[..., 0],
             fl * phi.photo_cell_HeI / bcols[..., 1],
             fl * phi.photo_cell_HeII / bcols[..., 2],
             fl * phi.heat], dim=-1)
        # the photon loss through the trace boundary
        # (evolve_point.F90:310-315)
        ploss = ploss + torch.where(live & on_bound,
                                    phi.photo_out / vol_ratio, 0.0).sum(-1)
        if lls_add is not None:
            # photons absorbed by the LLS fog (total_LLS_loss,
            # photonstatistics.f90:250-267, evolve_point.F90:277)
            tau_lls = const.sigma_HI_at_ion_freq * lls_add
            lloss = lloss + torch.where(
                live, phi.photo_in / vol_ratio * (-torch.expm1(-tau_lls)),
                0.0).sum(-1)
    return slab, ploss, lloss
