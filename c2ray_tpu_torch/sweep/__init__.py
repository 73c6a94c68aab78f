from .evolve3d import Evolve3DConfig, evolve3d, make_evolve3d_iteration
from .global_pass import ChemistryConfig, global_chemistry_pass
from .pyramid_sweep import sweep_pyramid_source_batch
from .source_sweep import RateGrids, SourceFields, SweepConfig

__all__ = [
    "Evolve3DConfig", "evolve3d", "make_evolve3d_iteration",
    "ChemistryConfig", "global_chemistry_pass",
    "sweep_pyramid_source_batch",
    "RateGrids", "SourceFields", "SweepConfig",
]
