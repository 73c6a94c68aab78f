"""The octant kernel's launch plan (c2ray_tpu_torch/sweep/octant_sweep.py):
the rows of valid positions each plane launches, the lanes per cell of
each plane and the photon-loss slots.  Host code only: the kernel
itself runs on the card (tests/test_torch_kernels.py, marker `gpu`).
"""

import numpy as np
import pytest
import torch

from c2ray_tpu_torch.sweep import octant_sweep as oc
from c2ray_tpu_torch.sweep.source_sweep import _BLOCK

torch.set_num_threads(1)

MESHES = [16, 18, 128]


def _expand(M):
    """(s, octant, b, c, position in the plane's compact order) of every
    position plane_rows lists, in its order, and the cells per plane."""
    row0, rows, cells = oc.plane_rows(M)
    planes = np.repeat(np.arange(1, 3 * (M // 2) + 1), np.diff(row0))
    # a row's length: up to the next row's first position, or to the
    # end of its plane
    nxt = np.append(rows[1:, 3], 0)
    last = np.append(planes[1:] != planes[:-1], True)
    n = np.where(last, cells[planes - 1], nxt) - rows[:, 3]
    k = np.repeat(np.arange(len(rows)), n)
    j = np.arange(len(k)) - np.repeat(np.cumsum(n) - n, n)
    return (planes[k], rows[k, 0], rows[k, 1], rows[k, 2] + j,
            rows[k, 3] + j), cells


def _kernel_mask(M):
    """The validity test the kernel applied to every position of the
    (R+1)^2 plane before it launched only the valid ones: a >= 0,
    a <= vx, b <= vy, c <= vz (v = R toward +, R - 1 toward -)."""
    R = M // 2
    s = np.arange(1, 3 * R + 1)[:, None, None, None]
    b = np.arange(R + 1)[None, None, :, None]
    c = np.arange(R + 1)[None, None, None, :]
    v = np.array([[R if sg > 0 else R - 1 for sg in signs]
                  for signs in oc._octant_signs()])
    vx, vy, vz = (v[:, k][None, :, None, None] for k in range(3))
    a = s - b - c
    return (a >= 0) & (a <= vx) & (b <= vy) & (c <= vz)


def _plain_masks(M):
    """The `valid` masks of octant_sweep_plain, plane by plane, built by
    its own expressions (its signs, vmax and index grids)."""
    R = M // 2
    signs = torch.tensor(oc._octant_signs())
    vm = torch.where(signs > 0, R, R - 1).view(8, 3, 1, 1)
    ar = torch.arange(R + 1)
    b = ar[:, None].expand(R + 1, R + 1)
    c = ar[None, :].expand(R + 1, R + 1)
    out = []
    for s in range(1, 3 * R + 1):
        a = s - b - c
        out.append(((a >= 0) & (a <= vm[:, 0]) & (b <= vm[:, 1])
                    & (c <= vm[:, 2])).numpy())
    return np.stack(out)


@pytest.mark.parametrize("M", MESHES)
def test_plane_rows_enumerate_exactly_the_valid_positions(M):
    (s, o, b, c, pos), cells = _expand(M)
    mask = _kernel_mask(M)
    np.testing.assert_array_equal(mask, _plain_masks(M))
    got = np.zeros_like(mask)
    np.add.at(got, (s - 1, o, b, c), True)
    np.testing.assert_array_equal(got, mask)
    assert len(s) == int(mask.sum())          # each position once
    # the compact order of a plane: octant, then b, then c, 0..cells-1
    order = np.lexsort((c, b, o, s))
    np.testing.assert_array_equal(order, np.arange(len(s)))
    np.testing.assert_array_equal(
        pos, np.arange(len(s)) - np.repeat(np.cumsum(cells) - cells, cells))
    np.testing.assert_array_equal(cells, mask.sum(axis=(1, 2, 3)))
    # every plane holds cells, and the owners (octant_sweep.cu's test:
    # positive octants own the zero faces) cover every offset of the
    # mesh but the source's once
    assert (cells > 0).all()
    pos_side = np.array(oc._octant_signs())[o] > 0
    owned = (((s - b - c > 0) | pos_side[:, 0]) & ((b > 0) | pos_side[:, 1])
             & ((c > 0) | pos_side[:, 2]))
    assert int(owned.sum()) == M**3 - 1 < int(cells.sum())


@pytest.mark.parametrize("S", [1, 3, 8, 64])
@pytest.mark.parametrize("M", MESHES)
def test_plane_lanes_are_a_function_of_the_cell_steps(M, S):
    row0, _, cells = oc.plane_rows(M)
    plan, _ = oc.plane_plan(S, row0, cells)
    assert plan.shape == (3 * (M // 2), 6)
    lanes = plan[:, 3]
    assert set(lanes) <= set(oc.PLANE_LANES)
    np.testing.assert_array_equal(
        lanes, [oc._plane_lanes(S * int(n)) for n in cells])
    # fewer lanes per cell on a wider plane, never more
    order = np.argsort(S * cells, kind="stable")
    assert (np.diff(lanes[order]) <= 0).all()
    # the rule covers every width, down to a plane of one cell
    for n in (1, 2**10, 2**14, 2**16, 2**20, 2**30):
        assert oc._plane_lanes(n) in oc.PLANE_LANES


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("M", MESHES)
def test_loss_slots_neither_overlap_nor_leave_gaps(M, S):
    row0, _, cells = oc.plane_rows(M)
    plan, nslots = oc.plane_plan(S, row0, cells)
    first_row, nrows, ncells, lanes, nblk, slot0 = plan.T
    np.testing.assert_array_equal(first_row, row0[:-1])
    np.testing.assert_array_equal(nrows, np.diff(row0))
    np.testing.assert_array_equal(ncells, cells)
    # each plane's blocks hold its cells' lane groups, with no block
    # to spare
    assert (nblk * _BLOCK >= ncells * lanes).all()
    assert ((nblk - 1) * _BLOCK < ncells * lanes).all()
    # slots: plane after plane, from 0 to nslots
    assert slot0[0] == 0
    np.testing.assert_array_equal(slot0[1:], np.cumsum(nblk)[:-1])
    assert nslots == int(nblk.sum())
    taken = np.zeros(nslots, dtype=int)
    for s0, n in zip(slot0, nblk):
        taken[s0:s0 + n] += 1
    assert (taken == 1).all()
