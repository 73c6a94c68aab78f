from .bands import Bands, NumFreq, make_bands
from .photo import PhotRates, zero_photrates
from .quadrature import QuadTables, build_quadrature_tables
from .sed import BlackBodySED, PowerLawSED, SEDConfig, normalize_seds

__all__ = [
    "Bands", "NumFreq", "make_bands",
    "PhotRates", "zero_photrates",
    "QuadTables", "build_quadrature_tables",
    "BlackBodySED", "PowerLawSED", "SEDConfig", "normalize_seds",
]
