"""Physical constants and conversion factors (cgs units).

The constants layer of C2-Ray (H + He version), identical to
``c2ray_tpu/constants.py``.  Parity references into the Fortran
reference tree:

- cgs constants / ionization energies / collisional-ionization
  parameters: ``code/cgsconstants.f90:26-103``
- photo cross sections at thresholds and cross terms:
  ``code/cgsphotoconstants.f90:25-50``
- astro constants: ``code/cgsastroconstants.f90``
- abundances: ``code/abundances.f90:23-32``
- adiabatic index: ``code/atomic.f90:23-25``
- math constants: ``code/mathconstants.f90``

Everything here is plain Python floats (device-independent); arrays are
built downstream at the precision requested by the caller.
"""

import math

# ---------------------------------------------------------------------------
# Math constants (mathconstants.f90)
# ---------------------------------------------------------------------------
pi = math.pi

# ---------------------------------------------------------------------------
# Fundamental constants, cgs (cgsconstants.f90:26-43)
# ---------------------------------------------------------------------------
m_p = 1.672661e-24        # proton mass [g]
c_light = 2.997925e+10    # speed of light [cm/s]
hplanck = 6.6260755e-27   # Planck constant [erg s]
sigma_SB = 5.670e-5       # Stefan-Boltzmann constant [erg cm^-2 s^-1 K^-4]
k_B = 1.381e-16           # Boltzmann constant [erg/K]
G_grav = 6.6732e-8        # gravitational constant

# conversions (cgsconstants.f90:38-53)
ev2k = 1.0 / 8.617e-05    # eV -> K
ev2erg = 1.602e-12        # eV -> erg
erg2j = 1e-7              # erg -> J
ev2fr = 0.241838e15       # eV -> Hz

two_pi_over_c_square = 2.0 * pi / (c_light * c_light)

# ---------------------------------------------------------------------------
# Recombination parameters at 1e4 K (cgsconstants.f90:63-73)
# ---------------------------------------------------------------------------
albpow = -0.7
bh00 = 2.59e-13           # H case-B at 1e4 K (OTS value)
alcpow = -0.672
bhe00 = 4.26e-13
bhe10 = 1.53e-12

# ---------------------------------------------------------------------------
# Ionization energies (cgsconstants.f90:75-103)
# ---------------------------------------------------------------------------
eth0 = 13.598                       # H ionization energy [eV]
hionen = eth0 * ev2erg              # [erg]
temph0 = eth0 * ev2k                # [K]
xih0 = 1.0
fh0 = 0.83
colh0 = 1.3e-8 * fh0 * xih0 / (eth0 * eth0)
n_el_crit = 4.0e3                   # critical electron density (Osterbrock)

ethe = (24.587, 54.416)             # He0, He+ ionization energies [eV]
heionen = (ethe[0] * ev2erg, ethe[1] * ev2erg)
temphe = (ethe[0] * ev2k, ethe[1] * ev2k)
xihe = (2.0, 1.0)
fhe = (0.63, 1.30)
colhe = (
    1.3e-8 * fhe[0] * xihe[0] / (ethe[0] * ethe[0]),
    1.3e-8 * fhe[1] * xihe[1] / (ethe[1] * ethe[1]),
)

# ---------------------------------------------------------------------------
# Photo cross sections (cgsphotoconstants.f90:25-50)
# ---------------------------------------------------------------------------
sigma_HI_at_ion_freq = 6.346e-18
sigma_HeI_at_ion_freq = 7.430e-18
sigma_HeII_at_ion_freq = 1.589e-18

ion_freq_HI = ev2fr * eth0
ion_freq_HeI = ev2fr * ethe[0]
ion_freq_HeII = ev2fr * ethe[1]

# cross terms used by the doric optical-depth ratios
sigma_H_heth = 1.238e-18      # HI cross-section at HeI ionization threshold
sigma_H_heLya = 9.907e-22     # HI cross-section at HeII Ly-alpha (40.817 eV)
sigma_He_heLya = 1.301e-20    # HeI cross-section at HeII Ly-alpha
sigma_He_he2 = 1.690780687052975e-18  # HeI cross-section at HeII threshold
sigma_H_he2 = 1.230695924714239e-19   # HI cross-section at HeII threshold

# ---------------------------------------------------------------------------
# Astro constants (cgsastroconstants.f90)
# ---------------------------------------------------------------------------
R_SOLAR = 6.9599e10       # [cm]
L_SOLAR = 3.826e33        # [erg/s]
M_SOLAR = 1.98892e33      # [g]
YEAR = 3.15576e7          # Julian year [s]
pc = 3.086e18             # parsec [cm]
kpc = 1e3 * pc
Mpc = 1e6 * pc

# ---------------------------------------------------------------------------
# Abundances (abundances.f90:23-32)
# ---------------------------------------------------------------------------
abu_he = 0.074            # He abundance by number
abu_c = 7.1e-7            # C abundance by number
abu_h = 1.0 - abu_he      # H abundance by number
mu = (1.0 - abu_he) + 4.0 * abu_he  # mean molecular weight

# ---------------------------------------------------------------------------
# Adiabatic index (atomic.f90:23-25)
# ---------------------------------------------------------------------------
gamma = 5.0 / 3.0
gamma1 = gamma - 1.0
