"""The device work of one rank of the domain decomposition.

Three kernels of ``csrc/domain_halo.cu``, each beside its plain PyTorch
version, which CPU tensors take (the wrapper of each dispatches on the
device; a CUDA tensor never reaches the plain version):

- `halo_pack`: the rank's stacked field slab, epsilon-floored, with the
  received x halos around it and periodic y / z pads
  (c2ray_tpu/parallel/domain.py:350-366); also the planes a rank sends;
- `window_accumulate`: one source's traced window added into the
  halo-extended rate slab (domain.py:393-397);
- `fold_halo`: the y / z pads folded back, then the received x-halo
  chunks added (domain.py:406-416); also the halo planes a rank sends.

Every result equals its plain version to the bit: the kernels copy, take
a max and add in the plain version's order.
"""

import ctypes

import torch

from .. import cuda_build
from ..utils.clocks import count


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the halo kernels take float32/float64, not {dtype}")


def _fn(name, argtypes):
    fn = getattr(cuda_build.load("domain_halo"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _need_cuda(what, *ts):
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError(f"the {what} kernel takes CUDA tensors")


def _dispatch(t, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no halo kernel for device {t.device}")


# ---- 6a: halo_pack

def _cyclic_pad(x, P, axis):
    """JAX's _cyclic_pad (domain.py:130): P periodic planes each side."""
    M = x.shape[axis]
    return torch.cat([x.narrow(axis, M - P, P), x, x.narrow(axis, 0, P)],
                     dim=axis)


def halo_pack_plain(fields, M, eps, left=None, right=None, pad=0,
                    planes=None):
    """Plain version of `halo_pack_cuda`."""
    S = fields[0].shape[0] // (M * M)
    c0, c1 = planes if planes is not None else (0, S)
    chans = [fields[0]] + [torch.clamp(f, min=eps) for f in fields[1:5]]
    chans += list(fields[5:])
    core = torch.stack(chans, dim=-1).reshape(S, M, M, len(fields))[c0:c1]
    x = torch.cat([t for t in (left, core, right) if t is not None], dim=0)
    return _cyclic_pad(_cyclic_pad(x, pad, 1), pad, 2).contiguous()


def halo_pack_cuda(fields, M, eps, left=None, right=None, pad=0,
                   planes=None):
    """The pack kernel: (X, M+2P, M+2P, C), X = HL + NC + HR.

    `fields`: 5 flat slabs (S*M*M,) [ndens, h_av0, h_av1, he_av0, he_av1]
    and optionally the LLS slab; `left` / `right`: (HL, M, M, C) and
    (HR, M, M, C) received halos, or None; `planes` = (c0, c1): the
    rank's x planes that go between them (all S by default); `pad`: the
    periodic y / z pad P."""
    _need_cuda("halo_pack", *fields, left, right)
    f = fields[0]
    dtype, device = f.dtype, f.device
    S = f.shape[0] // (M * M)
    planes = planes if planes is not None else (0, S)
    C = len(fields)
    c0, NC = planes[0], planes[1] - planes[0]
    HL = 0 if left is None else left.shape[0]
    HR = 0 if right is None else right.shape[0]
    shape = (HL + NC + HR, M + 2 * pad, M + 2 * pad, C)
    if C not in (5, 6) or not 0 <= c0 <= c0 + NC <= S or pad > M:
        raise ValueError(f"halo_pack: {C} channels, planes {planes} of {S}, "
                         f"pad {pad} at mesh {M}")
    for t in (*fields, left, right):
        if t is not None and (t.dtype != dtype or t.device != device):
            raise ValueError("halo_pack: one dtype and device")
    if any(t.shape != (S * M * M,) for t in fields):
        raise ValueError(f"halo_pack: fields must be ({S * M * M},)")
    for t, h in ((left, HL), (right, HR)):
        if t is not None and t.shape != (h, M, M, C):
            raise ValueError(f"halo_pack: halos must be (H, {M}, {M}, {C})")
    fields = [t.contiguous() for t in fields]
    left = None if left is None else left.contiguous()
    right = None if right is None else right.contiguous()
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    P = cuda_build.ptr
    null = ctypes.c_void_p(None)
    fn = _fn("halo_pack_" + _suffix(dtype),
             [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_double] + [ctypes.c_void_p] * 2)
    err = fn(*(P(t) for t in fields[:5]),
             P(fields[5]) if C == 6 else null, C,
             null if left is None else P(left),
             null if right is None else P(right),
             M, HL, c0, NC, HR, int(pad), float(eps), P(out),
             cuda_build.stream_of(out))
    cuda_build.check(err, "halo_pack")
    count("launches.domain_halo.pack")
    return out


def halo_pack(fields, M, eps, left=None, right=None, pad=0, planes=None):
    """The rank's stacked field slab with its halos (see
    `halo_pack_cuda`); CUDA tensors take the kernel, CPU tensors the
    plain version."""
    fn = _dispatch(fields[0], halo_pack_cuda, halo_pack_plain)
    return fn(fields, M, eps, left, right, pad, planes)


# ---- 6b: window_accumulate

def _window(rc, cube, start):
    Mw = cube.shape[0]
    if cube.shape != (Mw, Mw, Mw, 4) or rc.ndim != 4 or rc.shape[3] != 4:
        raise ValueError("window_accumulate: cube (Mw, Mw, Mw, 4) into rc "
                         "(X, Y, Z, 4)")
    s = tuple(int(v) for v in start)
    # JAX's dynamic_slice would clamp a window that does not fit; the
    # windows are built to fit, and here one that does not is an error
    if any(v < 0 or v + Mw > n for v, n in zip(s, rc.shape[:3])):
        raise ValueError(f"window at {s} of size {Mw} leaves rc "
                         f"{tuple(rc.shape[:3])}")
    return (slice(s[0], s[0] + Mw), slice(s[1], s[1] + Mw),
            slice(s[2], s[2] + Mw))


def window_accumulate_plain(rc, cube, start):
    """Plain version of `window_accumulate_cuda` (JAX's
    dynamic_update_slice(rc, patch + cube)); updates rc in place."""
    w = _window(rc, cube, start)
    rc[w] = rc[w] + cube
    return rc


def window_accumulate_cuda(rc, cube, start):
    """The window kernel: rc[start:start+Mw, ...] += cube, in place; rc
    (X, Y, Z, 4) contiguous, cube (Mw, Mw, Mw, 4)."""
    _need_cuda("window_accumulate", rc, cube)
    w = _window(rc, cube, start)
    if cube.dtype != rc.dtype or cube.device != rc.device:
        raise ValueError("window_accumulate: one dtype and device")
    if not rc.is_contiguous():
        raise ValueError("window_accumulate: rc must be contiguous")
    cube = cube.contiguous()
    fn = _fn("window_accumulate_" + _suffix(rc.dtype),
             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    P = cuda_build.ptr
    err = fn(P(rc), P(cube), *rc.shape[:3], cube.shape[0],
             *(s.start for s in w), cuda_build.stream_of(rc))
    cuda_build.check(err, "window_accumulate")
    count("launches.domain_halo.accumulate")
    return rc


def window_accumulate(rc, cube, start):
    """Add one traced window into the rate slab, in place."""
    fn = _dispatch(rc, window_accumulate_cuda, window_accumulate_plain)
    return fn(rc, cube, start)


# ---- 6c: fold_halo

def _fold_cyclic(x, P, axis):
    """JAX's _fold_cyclic (domain.py:137): the core, then the tail pad
    added, then the head pad."""
    M = x.shape[axis] - 2 * P
    core = x.narrow(axis, P, M).clone()
    core.narrow(axis, M - P, P).add_(x.narrow(axis, 0, P))
    core.narrow(axis, 0, P).add_(x.narrow(axis, P + M, P))
    return core


def fold_halo_plain(rc, M, planes, recv=None, chunks=(), planar=True):
    """Plain version of `fold_halo_cuda`."""
    x0, x1 = planes
    P = (rc.shape[1] - M) // 2
    v = _fold_cyclic(_fold_cyclic(rc[x0:x1], P, 1), P, 2)
    for b0, lo, n in chunks:
        v[lo:lo + n] += recv[b0:b0 + n]
    if planar:
        return v.permute(3, 0, 1, 2).reshape(4, -1)
    return v


_TABLES = {}


def _chunk_table(table, device):
    """The chunk table on the card, copied there once per table and
    device (a copy from pageable host memory waits for the stream)."""
    key = (table, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(table or (0,), dtype=torch.int32,
                                    device=device)
    return _TABLES[key]


def fold_halo_cuda(rc, M, planes, recv=None, chunks=(), planar=True):
    """The fold kernel on rc (X, M+2P, M+2P, 4): planes [x0, x1) with
    their y / z pads folded back, then each received chunk (b0, lo, n) --
    recv planes [b0, b0+n) added onto planes [lo, lo+n) of the result --
    in order.  `planar`: the four rate grids (4, (x1-x0)*M*M); else
    (x1-x0, M, M, 4)."""
    _need_cuda("fold_halo", rc, recv)
    x0, x1 = planes
    P = (rc.shape[1] - M) // 2
    nx = x1 - x0
    if (rc.ndim != 4 or rc.shape[1:] != (M + 2 * P, M + 2 * P, 4)
            or P > M or not 0 <= x0 <= x1 <= rc.shape[0]):
        raise ValueError(f"fold_halo: rc {tuple(rc.shape)}, planes {planes}"
                         f" at mesh {M}")
    if not rc.is_contiguous():
        raise ValueError("fold_halo: rc must be contiguous")
    dtype, device = rc.dtype, rc.device
    table = [int(v) for c in chunks for v in c]
    if chunks:
        if (recv is None or recv.dtype != dtype or recv.device != device
                or recv.shape[1:] != (M, M, 4)):
            raise ValueError("fold_halo: recv must be (n, M, M, 4) of rc's "
                             "dtype and device")
        for b0, lo, n in chunks:
            if not (0 <= b0 <= b0 + n <= recv.shape[0]
                    and 0 <= lo <= lo + n <= nx):
                raise ValueError(f"fold_halo: chunk {(b0, lo, n)} out of "
                                 "range")
        recv = recv.contiguous()
    shape = (4, nx * M * M) if planar else (nx, M, M, 4)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    tab = _chunk_table(tuple(table), device)
    fn = _fn("fold_halo_" + _suffix(dtype),
             [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    P_ = cuda_build.ptr
    err = fn(P_(rc), M, P, x0, nx,
             P_(recv) if chunks else ctypes.c_void_p(None), P_(tab),
             len(chunks), int(planar), P_(out), cuda_build.stream_of(rc))
    cuda_build.check(err, "fold_halo")
    count("launches.domain_halo.fold")
    return out


def fold_halo(rc, M, planes, recv=None, chunks=(), planar=True):
    """Fold the rate slab's halos back (see `fold_halo_cuda`)."""
    fn = _dispatch(rc, fold_halo_cuda, fold_halo_plain)
    return fn(rc, M, planes, recv, chunks, planar)
