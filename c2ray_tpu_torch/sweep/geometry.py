"""Causal wavefront decomposition of the 3D short-characteristics sweep.

Port of ``c2ray_tpu/sweep/geometry.py``.  All cells with
|di|+|dj|+|dk| = s are mutually independent and depend only on shells
<= s-1, because every cinterp corner moves at least one step toward the
source along the dominant axis and never away along any axis
(column_density.f90:93-95,124-142); a corner that stays in shell s
(offset 0 on an off-axis, stepped to -1) carries the bilinear weight
exactly 0.  The L1-shell engine processes each shell as one batch.

`build_shell_table` gives JAX's padded table, host numpy.  The padding
is most of it (55% at 128^3; 303 shells x 61,812 slots for 8.4M cells
at 203^3), so the sweep reads the compact form instead:
`ShellTable.packed` holds the cells sorted by shell, one int32 each, and
`ShellTable.starts` where each shell begins.
"""

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np

# ShellTable.packed: (di, dj, dk) + _BIAS in 10 bits each, the boundary
# flag in bit 30 (csrc/shell_sweep.cu unpacks it)
_BITS = 10
_BIAS = 1 << (_BITS - 1)
_BOUNDARY_BIT = 1 << 30


@dataclass(frozen=True, eq=False)
class ShellTable:
    """Padded per-shell cell offsets for a trace extent.

    offsets: (n_shells, width, 3) int32 -- (di, dj, dk) relative to the
      source; padding entries are (0,0,0) with mask False.
    mask: (n_shells, width) bool
    boundary: (n_shells, width) bool -- cell lies on the trace-volume
      boundary (photon-loss accounting, evolve_point.F90:310-315)
    lo, hi: per-axis trace extents (inclusive), reference
      evolve_source.F90:103-109: left M/2-1, right M/2 for periodic grids
    """

    offsets: np.ndarray
    mask: np.ndarray
    boundary: np.ndarray
    lo: tuple
    hi: tuple

    @property
    def n_shells(self) -> int:
        return self.offsets.shape[0]

    @property
    def width(self) -> int:
        return self.offsets.shape[1]

    @property
    def n_cells(self) -> int:
        return int(self.mask.sum())

    @cached_property
    def starts(self) -> np.ndarray:
        """(n_shells + 1,) int64: shell k is cells starts[k]:starts[k+1]
        of `cells` / `packed`."""
        return np.concatenate([[0], np.cumsum(self.mask.sum(axis=1))])

    @cached_property
    def cells(self) -> np.ndarray:
        """(n_cells, 3) int32 offsets, sorted by shell (the padded
        table's live entries in order)."""
        return self.offsets[self.mask]

    @cached_property
    def cell_boundary(self) -> np.ndarray:
        """(n_cells,) bool: `boundary` of each of `cells`."""
        return self.boundary[self.mask]

    @cached_property
    def packed(self) -> np.ndarray:
        """(n_cells,) int32: each of `cells` as
        (di + 512) | (dj + 512) << 10 | (dk + 512) << 20, with bit 30
        set on the trace boundary."""
        c = self.cells.astype(np.int64)
        if c.size and np.abs(c).max() >= _BIAS:
            raise ValueError(f"offsets beyond +-{_BIAS - 1} do not pack")
        p = ((c[:, 0] + _BIAS) | ((c[:, 1] + _BIAS) << _BITS)
             | ((c[:, 2] + _BIAS) << (2 * _BITS)))
        p = p | np.where(self.cell_boundary, _BOUNDARY_BIT, 0)
        return p.astype(np.int32)


@lru_cache(maxsize=32)
def build_shell_table(mesh: int, max_radius: int = None) -> ShellTable:
    """Build the wavefront table for a cubic mesh.

    ``max_radius`` limits the trace extent per axis (the reference's
    min(max_subbox, mesh/2) wall, evolve_source.F90:103-109,
    c2ray_parameters.f90:52-56).
    """
    half_r = mesh // 2
    half_l = half_r - 1 + mesh % 2
    if max_radius is not None:
        half_r = min(half_r, max_radius)
        half_l = min(half_l, max_radius)
    lo = (-half_l, -half_l, -half_l)
    hi = (half_r, half_r, half_r)

    rng = [np.arange(l, h + 1) for l, h in zip(lo, hi)]
    di, dj, dk = np.meshgrid(*rng, indexing="ij")
    di, dj, dk = di.ravel(), dj.ravel(), dk.ravel()
    s = np.abs(di) + np.abs(dj) + np.abs(dk)
    keep = s > 0  # source cell handled separately
    di, dj, dk, s = di[keep], dj[keep], dk[keep], s[keep]

    on_bound = ((di == lo[0]) | (di == hi[0])
                | (dj == lo[1]) | (dj == hi[1])
                | (dk == lo[2]) | (dk == hi[2]))

    n_shells = int(s.max())
    counts = np.bincount(s, minlength=n_shells + 1)[1:]
    width = int(counts.max())

    offsets = np.zeros((n_shells, width, 3), dtype=np.int32)
    mask = np.zeros((n_shells, width), dtype=bool)
    boundary = np.zeros((n_shells, width), dtype=bool)
    order = np.argsort(s, kind="stable")
    s_sorted = s[order]
    # position within shell: index along the sorted array minus the
    # start offset of that shell
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos_within = np.arange(len(order)) - starts[s_sorted - 1]
    sh = s_sorted - 1
    offsets[sh, pos_within, 0] = di[order]
    offsets[sh, pos_within, 1] = dj[order]
    offsets[sh, pos_within, 2] = dk[order]
    mask[sh, pos_within] = True
    boundary[sh, pos_within] = on_bound[order]

    return ShellTable(offsets=offsets, mask=mask, boundary=boundary,
                      lo=lo, hi=hi)
