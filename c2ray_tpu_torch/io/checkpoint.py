"""Checkpoint / resume.

Port of ``c2ray_tpu/io/checkpoint.py``: the reference's three-level
restart system (SURVEY.md section 5):
1. iteration dumps inside the convergence loop, written on a wall-clock
   cadence to alternating slots (evolve.F90:199-212, 233-367)
2. slice restart from the output cubes (mat_ini_test.F90:269-465) --
   covered by reading the stream-2/3 outputs back via io.readers
3. post-suppression source-list persistence
   (sourceprops_cubep3m.F90:415-516) -- `save_source_list`

The dump carries the same payload as the reference's iterdump[12].bin
(niter, photon loss, rate grids, av/intermediate fractions, temperature
slots) in a single .npz with the JAX package's keys, so each package
reads the other's dumps; tensors are copied to the host as numpy
arrays of their own dtype.  Alternating slots protect against
truncation on a crash mid-write, like the reference's two files.
"""

import os
import time
from typing import Optional

import numpy as np


def _host(leaf):
    """numpy array of a tensor (any device) or of anything np.asarray
    takes."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_iterdump(dump_dir, niter, state, rates, slot: Optional[int] = None,
                  **meta):
    """Write iterdump<slot>.npz (write_iteration_dump, evolve.F90:233-275).

    Extra keyword scalars (e.g. subbox_radius) are stored as metadata
    and returned by ``load_iterdump(with_meta=True)``."""
    os.makedirs(dump_dir, exist_ok=True)
    if slot is None:
        slot = 1 + (niter % 2)
    path = os.path.join(dump_dir, f"iterdump{slot}.npz")
    # np.savez appends .npz itself, so the temp name must end with it
    tmp = os.path.join(dump_dir, f".iterdump{slot}.tmp.npz")
    payload = {"niter": niter, "timestamp": time.time()}
    for k, v in meta.items():
        payload[f"meta_{k}"] = v
    for name, leaf in state._asdict().items():
        payload[f"state_{name}"] = _host(leaf)
    for name, leaf in rates._asdict().items():
        if leaf is None:  # optional fields (e.g. photon_loss_bands)
            continue
        payload[f"rates_{name}"] = _host(leaf)
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_iterdump(dump_dir, state_cls, rates_cls, slot: Optional[int] = None,
                  with_meta=False):
    """Read the newest (or requested) iteration dump
    (start_from_dump, evolve.F90:279-367); leaves are numpy arrays."""
    candidates = []
    for s in ([slot] if slot else (1, 2)):
        p = os.path.join(dump_dir, f"iterdump{s}.npz")
        if os.path.exists(p):
            candidates.append(p)
    if not candidates:
        raise FileNotFoundError(f"no iterdump in {dump_dir}")
    path = max(candidates, key=os.path.getmtime)
    with np.load(path) as z:
        niter = int(z["niter"])
        state = state_cls(**{name: z[f"state_{name}"]
                             for name in state_cls._fields})
        rates = rates_cls(**{name: z[f"rates_{name}"]
                             for name in rates_cls._fields
                             if f"rates_{name}" in z.files})
        meta = {k[5:]: z[k].item() for k in z.files
                if k.startswith("meta_")}
    if with_meta:
        return niter, state, rates, meta
    return niter, state, rates


def save_source_list(path, sources):
    """Persist a post-suppression source list
    (save_source_list, sourceprops_cubep3m.F90:465-516)."""
    with open(path, "w") as f:
        f.write(f"{sources.n_sources}\n")
        for pos, nf in zip(sources.srcpos, sources.nflux):
            f.write(f"{pos[0]+1} {pos[1]+1} {pos[2]+1} "
                    f"{nf[0]:.8e} {nf[1]:.8e} {nf[2]:.8e}\n")


def load_source_list(path):
    """Read back a saved source list."""
    from ..sources import SourceList

    with open(path) as f:
        n = int(f.readline().split()[0])
        rows = [[float(x) for x in f.readline().split()] for _ in range(n)]
    arr = np.asarray(rows) if rows else np.zeros((0, 6))
    return SourceList(srcpos=arr[:, :3].astype(np.int32) - 1,
                      nflux=arr[:, 3:6])
