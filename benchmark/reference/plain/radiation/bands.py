"""Frequency-band architecture for the multi-frequency photo-ionization.

Re-implementation of ``code/radiation_sizes.f90``: the band
layout and all per-sub-band physical data (frequency edges, band-averaged
cross sections, cross-section power-law indices, secondary-ionization
f-factors) are assembled into dense numpy arrays once at start-up and
shipped to the device as part of the radiation tables.

Band structure (radiation_sizes.f90:17-23):
  - band 1: [nu_HI, nu_HeI)      -- ionizes HI only
  - band 2: [nu_HeI, nu_HeII)    -- ionizes HI, HeI     (default 26 sub-bands)
  - band 3: [nu_HeII, 100*nu_HeII) -- ionizes HI, HeI, HeII (default 20)
Heating-table layout: 1 + 2*n2 + 3*n3 bins (113 for the default split)
ordered per sub-band as (HI[, HeI[, HeII]]) (radiation_tables.f90:327-383).

Alternate splits (n2 in {1,2,3,6,10,26}, n3 in {1,4,9,11,16,20}) are
supported for the photo tables; the secondary-ionization f-factor data
exists in the reference only for the (26, 20) split
(radiation_sizes.f90:194-372), so non-isothermal runs require it.
"""

from dataclasses import dataclass, field

import numpy as np

from .. import constants as const

NumFreq = 512   # integration points per sub-band (radiation_sizes.f90:17)
NumTau = 2000   # tau rows in the rate tables (radiation_sizes.f90:18)

# --- band-2 sub-band upper edges, in units of ion_freq_HeI
#     (radiation_sizes.f90:104-143); the last edge is ion_freq_HeII.
_BAND2_EDGES = {
    26: [1.02, 1.05, 1.07, 1.10, 1.15, 1.20, 1.25, 1.30, 1.35, 1.40, 1.45,
         1.50, 1.55, 1.60, 1.65, 1.70, 1.75, 1.80, 1.85, 1.90, 1.95, 2.00,
         2.05, 2.10, 2.15],
    10: [1.10, 1.20, 1.30, 1.40, 1.50, 1.60, 1.70, 1.80, 1.90],
    6: [1.15, 1.30, 1.50, 1.70, 1.9557],
    3: [1.3, 1.7],
    2: [1.5],
    1: [],
}

# --- band-3 sub-band upper edges, in units of ion_freq_HeII
#     (radiation_sizes.f90:145-177)
_BAND3_EDGES = {
    20: [1.05, 1.10, 1.20, 1.40, 1.70, 2.00, 2.50, 3.00, 4.00, 5.00, 7.00,
         10.00, 15.00, 20.00, 30.00, 40.00, 50.00, 70.00, 90.00, 100.00],
    16: [1.05, 1.10, 1.20, 1.40, 1.70, 2.00, 3.00, 5.00, 7.00, 10.00, 15.00,
         20.00, 30.00, 50.00, 70.00, 100.00],
    11: [1.10, 1.20, 1.50, 2.00, 3.00, 4.00, 7.00, 10.00, 20.00, 50.00,
         100.0],
    9: [1.50, 2.00, 3.00, 4.00, 7.00, 10.00, 20.00, 50.00, 100.00],
    4: [2.00, 4.00, 10.00, 100.0],
    1: [100.00],
}

# --- band-averaged cross sections (radiation_sizes.f90:377-545)
_SIGMA_HI_B2 = {
    26: [1.239152e-18, 1.171908e-18, 1.079235e-18, 1.023159e-18, 9.455687e-19,
         8.329840e-19, 7.374876e-19, 6.559608e-19, 5.859440e-19, 5.254793e-19,
         4.729953e-19, 4.272207e-19, 3.874251e-19, 3.521112e-19, 3.209244e-19,
         2.932810e-19, 2.686933e-19, 2.467523e-19, 2.271125e-19, 2.094813e-19,
         1.936094e-19, 1.792838e-19, 1.663215e-19, 1.545649e-19, 1.438778e-19,
         1.341418e-19],
    10: [1.239152e-18, 9.455687e-19, 7.374876e-19, 5.859440e-19, 4.729953e-19,
         3.874251e-19, 3.209244e-19, 2.686933e-19, 2.271125e-19, 1.936094e-19],
    6: [1.164e-18, 8.33e-19, 5.859e-19, 3.874e-19, 2.687e-19, 1.777e-19],
    3: [1.239e-18, 5.86e-19, 2.69e-19],
    2: [1.239e-18, 3.87e-19],
    1: [1.239e-18],
}
_SIGMA_HEI_B2 = {
    26: [7.434699e-18, 7.210641e-18, 6.887151e-18, 6.682491e-18, 6.387263e-18,
         5.931487e-18, 5.516179e-18, 5.137743e-18, 4.792724e-18, 4.477877e-18,
         4.190200e-18, 3.926951e-18, 3.687526e-18, 3.465785e-18, 3.261781e-18,
         3.073737e-18, 2.900074e-18, 2.739394e-18, 2.590455e-18, 2.452158e-18,
         2.323526e-18, 2.203694e-18, 2.091889e-18, 1.987425e-18, 1.889687e-18,
         1.798126e-18],
    10: [7.434699e-18, 6.387263e-18, 5.516179e-18, 4.792724e-18, 4.190200e-18,
         3.687526e-18, 3.261781e-18, 2.900074e-18, 2.590455e-18, 2.323526e-18],
    6: [const.sigma_HeI_at_ion_freq, 5.9315e-18, 4.7927e-18, 3.6875e-18,
        2.9001e-18, 2.1906e-18],
    3: [const.sigma_HeI_at_ion_freq, 4.793e-18, 2.90e-18],
    2: [const.sigma_HeI_at_ion_freq, 3.688e-18],
    1: [const.sigma_HeI_at_ion_freq],
}
_SIGMA_HI_B3 = {
    20: [1.230696e-19, 1.063780e-19, 9.253883e-20, 7.123014e-20, 4.464019e-20,
         2.465533e-20, 1.492667e-20, 7.446712e-21, 4.196728e-21, 1.682670e-21,
         8.223247e-22, 2.763830e-22, 8.591126e-23, 2.244684e-23, 8.593853e-24,
         2.199718e-24, 8.315674e-25, 3.898672e-25, 1.238718e-25, 5.244957e-26],
    16: [1.230696e-19, 1.063780e-19, 9.253883e-20, 7.123014e-20, 4.464019e-20,
         2.465533e-20, 1.492667e-20, 4.196728e-21, 8.223247e-22, 2.763830e-22,
         8.591126e-23, 2.244684e-23, 8.593853e-24, 2.199718e-24, 3.898672e-25,
         1.238718e-25],
    11: [1.2307e-19, 9.2539e-20, 7.1230e-20, 3.6176e-20, 1.4927e-20,
         4.1967e-21, 1.6827e-21, 2.7638e-22, 8.5911e-23, 8.5939e-24,
         3.8987e-25],
    9: [1.230696e-19, 3.617600e-20, 1.492667e-20, 4.196728e-21, 1.682670e-21,
        2.763830e-22, 8.591126e-23, 8.593853e-24, 3.898672e-25],
    4: [1.2307e-19, 1.4927e-20, 1.6827e-21, 8.5900e-23],
    1: [1.2300e-19],
}
_SIGMA_HEI_B3 = {
    20: [1.690781e-18, 1.521636e-18, 1.373651e-18, 1.128867e-18, 7.845096e-19,
         4.825331e-19, 3.142134e-19, 1.696228e-19, 1.005051e-19, 4.278712e-20,
         2.165403e-20, 7.574790e-21, 2.429426e-21, 6.519748e-22, 2.534069e-22,
         6.599821e-23, 2.520412e-23, 1.189810e-23, 3.814490e-24, 1.624492e-24],
    16: [1.690781e-18, 1.521636e-18, 1.373651e-18, 1.128867e-18, 7.845096e-19,
         4.825331e-19, 3.142134e-19, 1.005051e-19, 2.165403e-20, 7.574790e-21,
         2.429426e-21, 6.519748e-22, 2.534069e-22, 6.599821e-23, 1.189810e-23,
         3.814490e-24],
    11: [1.6908e-18, 1.3737e-18, 1.1289e-18, 6.6238e-19, 3.1421e-19,
         1.0051e-19, 4.2787e-20, 7.5748e-21, 2.4294e-21, 2.5341e-22,
         1.1898e-23],
    9: [1.690781e-18, 6.623773e-19, 3.142134e-19, 1.005051e-19, 4.278712e-20,
        7.574790e-21, 2.429426e-21, 2.534069e-22, 1.189810e-23],
    4: [1.6908e-18, 3.1421e-19, 4.2787e-20, 2.4294e-21],
    1: [1.691e-18],
}
_SIGMA_HEII_B3 = {
    20: [1.587280e-18, 1.391911e-18, 1.227391e-18, 9.686899e-19, 6.338284e-19,
         3.687895e-19, 2.328072e-19, 1.226873e-19, 7.214988e-20, 3.081577e-20,
         1.576429e-20, 5.646276e-21, 1.864734e-21, 5.177347e-22, 2.059271e-22,
         5.526508e-23, 2.151467e-23, 1.029637e-23, 3.363164e-24, 1.450239e-24],
    16: [1.587280e-18, 1.391911e-18, 1.227391e-18, 9.686899e-19, 6.338284e-19,
         3.687895e-19, 2.328072e-19, 7.214988e-20, 1.576429e-20, 5.646276e-21,
         1.864734e-21, 5.177347e-22, 2.059271e-22, 5.526508e-23, 1.029637e-23,
         3.363164e-24],
    11: [1.5873e-18, 1.2274e-18, 9.6869e-19, 5.2339e-19, 2.3281e-19,
         7.2150e-20, 3.0816e-20, 5.6463e-21, 1.8647e-21, 2.0593e-22,
         1.0296e-23],
    9: [const.sigma_HeII_at_ion_freq, 5.233870e-19, 2.328072e-19, 7.214988e-20,
        3.081577e-20, 5.646276e-21, 1.864734e-21, 2.059271e-22, 1.029637e-23],
    4: [1.5873e-18, 2.3280e-19, 3.0816e-20, 1.1865e-21],
    1: [const.sigma_HeII_at_ion_freq],
}

# --- cross-section power-law indices (radiation_sizes.f90:550-686)
_PLI_HI_B1 = 2.761
_PLI_HI_B2 = {
    26: [2.8277, 2.8330, 2.8382, 2.8432, 2.8509, 2.8601, 2.8688, 2.8771,
         2.8850, 2.8925, 2.8997, 2.9066, 2.9132, 2.9196, 2.9257, 2.9316,
         2.9373, 2.9428, 2.9481, 2.9532, 2.9582, 2.9630, 2.9677, 2.9722,
         2.9766, 2.9813],
    10: [2.8360, 2.8554, 2.8729, 2.8887, 2.9031, 2.9164, 2.9287, 2.9400,
         2.9507, 2.9701],
    6: [2.8408, 2.8685, 2.8958, 2.9224, 2.9481, 2.9727],
    3: [2.8542, 2.9086, 2.9600],
    2: [2.8697, 2.9486],
    1: [2.9118],
}
_PLI_HEI_B2 = {
    26: [1.5509, 1.5785, 1.6047, 1.6290, 1.6649, 1.7051, 1.7405, 1.7719,
         1.8000, 1.8253, 1.8486, 1.8701, 1.8904, 1.9098, 1.9287, 1.9472,
         1.9654, 1.9835, 2.0016, 2.0196, 2.0376, 2.0557, 2.0738, 2.0919,
         2.1099, 2.1302],
    10: [1.5932, 1.6849, 1.7561, 1.8126, 1.8592, 1.9000, 1.9379, 1.9744,
         2.0105, 2.0840],
    6: [1.6168, 1.7390, 1.8355, 1.9186, 2.0018, 2.0945],
    3: [1.6770, 1.8758, 2.0458],
    2: [1.7385, 2.0061],
    1: [1.8832],
}
_PLI_HI_B3 = {
    20: [2.9884, 2.9970, 3.0088, 3.0298, 3.0589, 3.0872, 3.1166, 3.1455,
         3.1773, 3.2089, 3.2410, 3.2765, 3.3107, 3.3376, 3.3613, 3.3816,
         3.3948, 3.4078, 3.4197, 3.4379],
    16: [2.9884, 2.9970, 3.0088, 3.0298, 3.0589, 3.0872, 3.1303, 3.1920,
         3.2410, 3.2765, 3.3107, 3.3376, 3.3613, 3.3878, 3.4078, 3.4343],
    11: [2.9926, 3.0088, 3.0357, 3.0777, 3.1303, 3.1773, 3.2292, 3.2765,
         3.3230, 3.3775, 3.4155],
    9: [3.0207, 3.0777, 3.1303, 3.1773, 3.2292, 3.2765, 3.3230, 3.3775,
        3.4155],
    4: [3.0465, 3.1516, 3.2501, 3.3833],
    1: [3.3369],
}
_PLI_HEI_B3 = {
    20: [2.1612, 2.2001, 2.2564, 2.3601, 2.5054, 2.6397, 2.7642, 2.8714,
         2.9700, 3.0528, 3.1229, 3.1892, 3.2451, 3.2853, 3.3187, 3.3464,
         3.3640, 3.3811, 3.3967, 3.4203],
    16: [2.1612, 2.2001, 2.2564, 2.3601, 2.5054, 2.6397, 2.8157, 3.0093,
         3.1229, 3.1892, 3.2451, 3.2853, 3.3187, 3.3546, 3.3811, 3.4157],
    11: [2.1803, 2.2564, 2.3901, 2.5951, 2.8157, 2.9700, 3.0976, 3.1892,
         3.2636, 3.3407, 3.3913],
    9: [2.3157, 2.5951, 2.8157, 2.9700, 3.0976, 3.1892, 3.2636, 3.3407,
        3.3913],
    4: [2.4431, 2.8878, 3.1390, 3.3479],
    1: [3.2681],
}
_PLI_HEII_B3 = {
    20: [2.6930, 2.7049, 2.7213, 2.7503, 2.7906, 2.8300, 2.8711, 2.9121,
         2.9577, 3.0041, 3.0522, 3.1069, 3.1612, 3.2051, 3.2448, 3.2796,
         3.3027, 3.3258, 3.3472, 3.3805],
    16: [2.6930, 2.7049, 2.7213, 2.7503, 2.7906, 2.8300, 2.8904, 2.9793,
         3.0522, 3.1069, 3.1612, 3.2051, 3.2448, 3.2904, 3.3258, 3.3740],
    11: [2.6989, 2.7213, 2.7585, 2.8167, 2.8904, 2.9577, 3.0345, 3.1069,
         3.1811, 3.2727, 3.3397],
    9: [2.7377, 2.8167, 2.8904, 2.9577, 3.0345, 3.1069, 3.1811, 3.2727,
        3.3397],
    4: [2.7735, 2.9209, 3.0663, 3.2833],
    1: [3.2082],
}

# --- secondary-ionization f-factors for the (26, 20) split
#     (radiation_sizes.f90:198-370).  Band-2 entries then band-3 entries.
_F_B2 = {
    "f1ion_HI": [0.0] * 16 + [1.0] * 10,
    "f1ion_HeI": [0.0] * 25 + [1.0],
    "f1ion_HeII": [0.0] * 26,
    "f2ion_HI": [0.0] * 16 + [0.9971, 0.9802, 0.9643, 0.9493, 0.9350, 0.9215,
                              0.9086, 0.8964, 0.8847, 0.8735],
    "f2ion_HeI": [0.0] * 25 + [0.9960],
    "f2ion_HeII": [0.0] * 26,
    "f1heat_HI": [0.0] + [1.0] * 25,
    "f1heat_HeI": [0.0] * 11 + [1.0] * 15,
    "f1heat_HeII": [0.0] * 26,
    "f2heat_HI": [0.0, 0.9704, 0.9290, 0.9037, 0.8687, 0.8171, 0.7724, 0.7332,
                  0.6985, 0.6675, 0.6397, 0.6145, 0.5916, 0.5707, 0.5514,
                  0.5337, 0.5173, 0.5021, 0.4879, 0.4747, 0.4623, 0.4506,
                  0.4397, 0.4293, 0.4196, 0.4103],
    "f2heat_HeI": [0.0] * 11 + [0.9959, 0.9250, 0.8653, 0.8142, 0.7698,
                                0.7309, 0.6965, 0.6657, 0.6380, 0.6130,
                                0.5903, 0.5694, 0.5503, 0.5327, 0.5164],
    "f2heat_HeII": [0.0] * 26,
}
_F_B3 = {
    "f1ion_HI": [1.0] * 20,
    "f1ion_HeI": [1.0] * 20,
    "f1ion_HeII": [0.0] * 5 + [1.0] * 15,
    "f2ion_HI": [0.8600, 0.8381, 0.8180, 0.7824, 0.7249, 0.6607, 0.6128,
                 0.5542, 0.5115, 0.4518, 0.4110, 0.3571, 0.3083, 0.2612,
                 0.2325, 0.1973, 0.1757, 0.1606, 0.1403, 0.1269],
    "f2ion_HeI": [0.9750, 0.9415, 0.9118, 0.8609, 0.7831, 0.7015, 0.6436,
                  0.5755, 0.5273, 0.4619, 0.4182, 0.3615, 0.3109, 0.2627,
                  0.2334, 0.1979, 0.1761, 0.1609, 0.1405, 0.1270],
    "f2ion_HeII": [0.0] * 5 + [0.8841, 0.7666, 0.6518, 0.5810, 0.4940, 0.4403,
                               0.3744, 0.3183, 0.2668, 0.2361, 0.1993, 0.1771,
                               0.1616, 0.1409, 0.1273],
    "f1heat_HI": [1.0] * 20,
    "f1heat_HeI": [1.0] * 20,
    "f1heat_HeII": [0.0] * 4 + [1.0] * 16,
    "f2heat_HI": [0.3994, 0.3817, 0.3659, 0.3385, 0.2961, 0.2517, 0.2207,
                  0.1851, 0.1608, 0.1295, 0.1097, 0.0858, 0.0663, 0.0496,
                  0.0405, 0.0304, 0.0248, 0.0212, 0.0167, 0.0140],
    "f2heat_HeI": [0.4974, 0.4679, 0.4424, 0.4001, 0.3389, 0.2796, 0.2405,
                   0.1977, 0.1697, 0.1346, 0.1131, 0.0876, 0.0673, 0.0501,
                   0.0408, 0.0305, 0.0249, 0.0213, 0.0168, 0.0140],
    "f2heat_HeII": [0.0] * 4 + [0.6202, 0.4192, 0.3265, 0.2459, 0.2010,
                                0.1513, 0.1237, 0.0932, 0.0701, 0.0515,
                                0.0416, 0.0309, 0.0251, 0.0214, 0.0169,
                                0.0141],
}

# the f-factor names, in the order the kernels' band rows hold them
F_FACTORS = ("f1ion_HI", "f1ion_HeI", "f1ion_HeII",
             "f2ion_HI", "f2ion_HeI", "f2ion_HeII",
             "f1heat_HI", "f1heat_HeI", "f1heat_HeII",
             "f2heat_HI", "f2heat_HeI", "f2heat_HeII")


@dataclass(frozen=True)
class Bands:
    """Complete frequency-band data, numpy float64, shape (nbands,)."""

    nbnd1: int
    nbnd2: int
    nbnd3: int
    freq_min: np.ndarray
    freq_max: np.ndarray
    delta_freq: np.ndarray
    sigma_HI: np.ndarray
    sigma_HeI: np.ndarray
    sigma_HeII: np.ndarray
    pli_HI: np.ndarray   # cross-section power-law index used per sub-band
    pli_HeI: np.ndarray
    pli_HeII: np.ndarray
    # secondary ionization factors, zero-padded in band 1 (shape (nbands,))
    f1ion_HI: np.ndarray = field(default=None)
    f1ion_HeI: np.ndarray = field(default=None)
    f1ion_HeII: np.ndarray = field(default=None)
    f2ion_HI: np.ndarray = field(default=None)
    f2ion_HeI: np.ndarray = field(default=None)
    f2ion_HeII: np.ndarray = field(default=None)
    f1heat_HI: np.ndarray = field(default=None)
    f1heat_HeI: np.ndarray = field(default=None)
    f1heat_HeII: np.ndarray = field(default=None)
    f2heat_HI: np.ndarray = field(default=None)
    f2heat_HeI: np.ndarray = field(default=None)
    f2heat_HeII: np.ndarray = field(default=None)
    # optical depths at the grid boundary (radiation_sizes.f90:27-29)
    boundary_tauHI: float = 0.0
    boundary_tauHeI: float = 0.0
    boundary_tauHeII: float = 0.0
    # rate tables built against these bands are stored divided by this
    # factor (float32 range guard; see radiation.tables)
    flux_scale: float = 1.0

    @property
    def nbands(self) -> int:
        return self.nbnd1 + self.nbnd2 + self.nbnd3

    @property
    def nheatbins(self) -> int:
        return self.nbnd1 + 2 * self.nbnd2 + 3 * self.nbnd3

    def heat_bin_index(self, i_subband: int, species: int) -> int:
        """Column in the heating tables for (sub-band, species).

        species: 0=HI, 1=HeI, 2=HeII.  Layout per
        radiation_tables.f90:289,327-328,381-383 (0-based here).
        """
        n1, n2 = self.nbnd1, self.nbnd2
        if i_subband < n1:
            assert species == 0
            return i_subband
        if i_subband < n1 + n2:
            assert species in (0, 1)
            return n1 + 2 * (i_subband - n1) + species
        assert species in (0, 1, 2)
        return n1 + 2 * n2 + 3 * (i_subband - n1 - n2) + species


def make_bands(nbnd2: int = 26, nbnd3: int = 20, *, boundary_tauHI=0.0,
               boundary_tauHeI=0.0, boundary_tauHeII=0.0) -> Bands:
    """Assemble the band data (radiation_sizes.f90:62-688)."""
    if nbnd2 not in _BAND2_EDGES or nbnd3 not in _BAND3_EDGES:
        raise ValueError(f"unsupported band split ({nbnd2}, {nbnd3})")

    freq_max = np.concatenate([
        [const.ion_freq_HeI],
        np.array(_BAND2_EDGES[nbnd2]) * const.ion_freq_HeI,
        [const.ion_freq_HeII],
        np.array(_BAND3_EDGES[nbnd3]) * const.ion_freq_HeII,
    ])
    freq_min = np.concatenate([[const.ion_freq_HI], freq_max[:-1]])
    delta_freq = (freq_max - freq_min) / float(NumFreq)

    z2, z3 = [0.0] * nbnd2, [0.0] * nbnd3
    sigma_HI = np.array([const.sigma_HI_at_ion_freq]
                        + _SIGMA_HI_B2[nbnd2] + _SIGMA_HI_B3[nbnd3])
    sigma_HeI = np.array([0.0] + _SIGMA_HEI_B2[nbnd2] + _SIGMA_HEI_B3[nbnd3])
    sigma_HeII = np.array([0.0] + z2 + _SIGMA_HEII_B3[nbnd3])

    pli_HI = np.array([_PLI_HI_B1] + _PLI_HI_B2[nbnd2] + _PLI_HI_B3[nbnd3])
    pli_HeI = np.array([0.0] + _PLI_HEI_B2[nbnd2] + _PLI_HEI_B3[nbnd3])
    pli_HeII = np.array([0.0] + z2 + _PLI_HEII_B3[nbnd3])

    fkw = {}
    if (nbnd2, nbnd3) == (26, 20):
        for name in _F_B2:
            fkw[name] = np.array([0.0] + _F_B2[name] + _F_B3[name])

    return Bands(
        nbnd1=1, nbnd2=nbnd2, nbnd3=nbnd3,
        freq_min=freq_min, freq_max=freq_max, delta_freq=delta_freq,
        sigma_HI=sigma_HI, sigma_HeI=sigma_HeI, sigma_HeII=sigma_HeII,
        pli_HI=pli_HI, pli_HeI=pli_HeI, pli_HeII=pli_HeII,
        boundary_tauHI=boundary_tauHI, boundary_tauHeI=boundary_tauHeI,
        boundary_tauHeII=boundary_tauHeII,
        **fkw,
    )
