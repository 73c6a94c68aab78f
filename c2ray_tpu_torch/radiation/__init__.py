from .bands import Bands, NumFreq, NumTau, make_bands
from .photo import PhotRates, photoion_rates, zero_photrates
from .quadrature import QuadTables, build_quadrature_tables
from .sed import BlackBodySED, PowerLawSED, SEDConfig, normalize_seds
from .tables import RadiationTables, build_radiation_tables, dlogtau, minlogtau

__all__ = [
    "Bands", "NumFreq", "NumTau", "make_bands",
    "PhotRates", "photoion_rates", "zero_photrates",
    "QuadTables", "build_quadrature_tables",
    "BlackBodySED", "PowerLawSED", "SEDConfig", "normalize_seds",
    "RadiationTables", "build_radiation_tables", "dlogtau", "minlogtau",
]
