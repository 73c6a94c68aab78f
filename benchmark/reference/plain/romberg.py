"""Romberg integration weights (host-side, numpy).

Weight-table Romberg scheme equivalent to ``code/romberg.f90:22-187``:
for a uniform grid of 2^p + 1 points, precompute per-point weights such
that sum(f * w * dx) equals the Romberg (Richardson-extrapolated
trapezoid) integral.  Used only at initialisation time to build the
radiation tables, so it stays in numpy on the host.
"""

import numpy as np

_MAXPOW = 14


def romberg_weights(n: int) -> np.ndarray:
    """Weights for a grid of n+1 points, n = 2^p (romberg.f90:22-90)."""
    if n == 1:
        return np.array([1.0])
    p = int(round(np.log2(n)))
    if 2**p != n:
        raise ValueError("number of intervals must be a power of 2")

    # Richardson extrapolation coefficients
    a = np.zeros(p + 1)
    b = np.zeros(p + 1)
    for k in range(1, p + 1):
        b[k] = -1.0 / (4.0**k - 1.0)
        a[k] = -b[k] * 4.0**k

    w = np.zeros(n + 1)
    s = np.zeros((p + 1, p + 1))
    for k in range(p + 1):
        s[:, 0] = 0.0
        s[k, 0] = 1.0
        for j in range(1, p + 1):
            for i in range(p, j - 1, -1):
                s[i, j] = a[j] * s[i, j - 1] + b[j] * s[i - 1, j - 1]
        # s[p, p] is the weight of the 2^k-point trapezoid sum in the
        # extrapolated integral on the 2^p grid
        stride = 2 ** (p - k)
        w[::stride] += s[p, p] * stride
    # halve the end points (trapezoid ends)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def romberg_integrate(f: np.ndarray, dx: float, axis: int = -1) -> np.ndarray:
    """Romberg-integrate samples f on a uniform grid of spacing dx.

    f.shape[axis] must be 2^p + 1.  Vectorised over all other axes
    (the reference's ``vector_romberg``, romberg.f90:158-187).
    """
    n = f.shape[axis] - 1
    w = romberg_weights(n)
    shape = [1] * f.ndim
    shape[axis] = n + 1
    return np.sum(f * w.reshape(shape), axis=axis) * dx
