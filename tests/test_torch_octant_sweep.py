"""Skewed-octant engine: the port's plain version against the JAX
package, and the three engines against each other.

16^3 random fields, 3 sources (one on a grid edge), float64, the cases
of tests/test_torch_shell_sweep.py.  The octant engine reports no LLS
loss, even with a homogeneous LLS column (JAX octant_sweep.py:328).  At
the full periodic extents the port's shell, octant and pyramid plain
versions compute one function: rtol 1e-10 (the JAX package's own
pyramid-vs-octant tolerance, tests/test_pyramid_sweep.py:48-53).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c2ray_tpu.sweep.octant_sweep import \
    sweep_octant_source_batch as j_octant
from c2ray_tpu_torch.sweep import (build_shell_table, octant_sweep,
                                   sweep_octant_source_batch,
                                   sweep_pyramid_source_batch,
                                   sweep_sources_accumulate)
from c2ray_tpu_torch.utils.clocks import counter
from test_torch_shell_sweep import _case, _check, _jfields, _tfields

# one intra-op thread: the suite runs in parallel workers, and at
# these small shapes torch's per-op thread pool only oversubscribes
# the cores (several times slower)
torch.set_num_threads(1)

M = 16


@pytest.mark.parametrize("lls", [0.0, 1.0e15])
@pytest.mark.parametrize("heating", [False, True])
def test_octant_matches_jax(heating, lls):
    jcfg, tcfg, fields, srcpos, nflux = _case(M, not heating, lls)
    ref = j_octant(jcfg, _jfields(fields), jnp.asarray(srcpos, jnp.int32),
                   jnp.asarray(nflux))
    counts = lambda: (counter("launches.octant_sweep"),
                      counter("launches.octant_sweep.heat"))
    before = counts()
    got = sweep_octant_source_batch(tcfg, _tfields(fields),
                                    torch.as_tensor(srcpos),
                                    torch.as_tensor(nflux))
    assert counts() == before, \
        "CPU tensors take the plain version"
    _check(got, ref)
    assert float(got.photon_loss) > 0.0
    assert float(got.lls_loss) == 0.0 == float(ref.lls_loss)
    assert (float(got.phiheat.abs().max()) > 0.0) == heating


@pytest.mark.parametrize("heating", [False, True])
def test_three_engines_agree(heating):
    _, tcfg, fields, srcpos, nflux = _case(M, not heating, 1.0e15, S=4)
    nflux[2] = 0.0    # a dead source too
    args = (_tfields(fields), torch.as_tensor(srcpos),
            torch.as_tensor(nflux))
    pyramid = sweep_pyramid_source_batch(tcfg, *args)
    shells = sweep_sources_accumulate(tcfg, build_shell_table(M), *args)
    octant = sweep_octant_source_batch(tcfg, *args)
    names = ("phih", "phihe0", "phihe1", "phiheat", "photon_loss")
    for other in (shells, octant):
        for name in names:
            a, b = getattr(other, name), getattr(pyramid, name)
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * float(b.abs().max()),
                                       msg=name)
    # the LLS loss: the shell engine's equals the pyramid's, the octant
    # engine reports none
    torch.testing.assert_close(shells.lls_loss, pyramid.lls_loss, rtol=1e-10,
                               atol=0.0)
    assert float(pyramid.lls_loss) > 0.0 == float(octant.lls_loss)


def test_octant_needs_an_even_mesh():
    _, tcfg, fields, srcpos, nflux = _case(15)
    with pytest.raises(ValueError, match="even mesh"):
        sweep_octant_source_batch(tcfg, _tfields(fields),
                                  torch.as_tensor(srcpos),
                                  torch.as_tensor(nflux))
    # a mesh of no sources sweeps nothing
    _, tcfg, fields, srcpos, nflux = _case(M)
    empty = sweep_octant_source_batch(tcfg, _tfields(fields),
                                      torch.as_tensor(srcpos[:0]),
                                      torch.as_tensor(nflux[:0]))
    assert all(float(t.abs().max()) == 0.0 for t in empty if t is not None)
    np.testing.assert_array_equal(empty.phih.numpy(), np.zeros(M**3))
