"""All C2-Ray tunables in one place.

Port of ``c2ray_tpu/parameters.py``, with the same values.  Central
re-export of the compile-time parameter constants that the
reference scatters over ``code/c2ray_parameters.f90`` (and its _TEST4
variant) so they are discoverable and overridable without hunting
through modules.  The operational values live next to the code that
uses them; this module documents the full set with its reference lines.
"""

from .constants import YEAR
from .onedim.evolve import (MAX_CELL_ITER, MAX_COLDENSH_1D)
from .sweep.evolve3d import CONVERGENCE_FRACTION, MAX_GLOBAL_ITER
from .sweep.global_pass import (MAX_CHEM_ITER, MIN_FRACTION_OF_ATOMS,
                                MIN_FRACTIONAL_CHANGE)
from .sweep.source_sweep import MAX_COLDENSH
from .thermal import MAX_SUBSTEPS, MINITEMP, RELATIVE_DENERGY

# c2ray_parameters.f90:32 -- a really small number
EPSILON = 1.0e-20

# c2ray_parameters.f90:51-56 -- subbox growth + photon wall (the shell
# engine's max_radius argument; the octant engine always traces M/2)
SUBBOXSIZE = 10
MAX_SUBBOX = 1150

# c2ray_parameters.f90:59 -- photon-loss redistribution (off, as in the
# reference whose implementation is incomplete, evolve_point.F90:650-731)
ADD_PHOTON_LOSSES = False

# c2ray_parameters.f90:67-78 -- material model selectors (see
# material.ClumpingModel / material.LLSModel)
TYPE_OF_CLUMPING = 1
CLUMPING_FACTOR = 1.0
USE_LLS = False
TYPE_OF_LLS = 1

# c2ray_parameters.f90:81-84
STOP_ON_PHOTON_VIOLATION = False
COSMOLOGICAL = True

# c2ray_parameters.f90:92-110 -- source-model constants
# (sources.HaloSourceModel defaults)
NUMBER_SOURCETYPES = 2
PHOT_PER_ATOM = (10.0, 150.0)
XRAY_PHOT_PER_ATOM = 0.02
SOURCE_LIFETIME = 20e6 * YEAR
MIN_PARTICLE_CONTENT = 20.0
STILL_NEUTRAL = 0.1

# c2ray_parameters_TEST4.f90 overrides (variant used for Iliev Test 4):
TEST4_OVERRIDES = {
    "SOURCE_LIFETIME": 3e6 * YEAR,     # :100-102
    "PHOT_PER_ATOM": (250.0, 250.0),   # :100
    "T_EFF_NOMINAL": 1.0e5,            # :56
    "S_STAR_NOMINAL": 1.0e52,          # :58
    "SUBBOXSIZE": None,                # full mesh (:46)
}

__all__ = [
    "EPSILON", "CONVERGENCE_FRACTION", "MAX_GLOBAL_ITER",
    "MIN_FRACTIONAL_CHANGE", "MIN_FRACTION_OF_ATOMS", "MAX_CHEM_ITER",
    "MAX_COLDENSH", "MAX_COLDENSH_1D", "MAX_CELL_ITER",
    "MINITEMP", "RELATIVE_DENERGY", "MAX_SUBSTEPS",
    "SUBBOXSIZE", "MAX_SUBBOX", "ADD_PHOTON_LOSSES",
    "TYPE_OF_CLUMPING", "CLUMPING_FACTOR", "USE_LLS", "TYPE_OF_LLS",
    "STOP_ON_PHOTON_VIOLATION", "COSMOLOGICAL",
    "NUMBER_SOURCETYPES", "PHOT_PER_ATOM", "XRAY_PHOT_PER_ATOM",
    "SOURCE_LIFETIME", "MIN_PARTICLE_CONTENT", "STILL_NEUTRAL",
    "TEST4_OVERRIDES",
]
