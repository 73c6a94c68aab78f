from .cinterp import cinterp_shell
from .evolve3d import Evolve3DConfig, evolve3d, make_evolve3d_iteration
from .geometry import ShellTable, build_shell_table
from .global_pass import ChemistryConfig, global_chemistry_pass
from .octant_sweep import sweep_octant_source_batch
from .pyramid_sweep import sweep_pyramid_source_batch
from .source_sweep import (RateGrids, SourceFields, SweepConfig,
                           sweep_sources_accumulate)

__all__ = [
    "Evolve3DConfig", "evolve3d", "make_evolve3d_iteration",
    "ChemistryConfig", "global_chemistry_pass",
    "ShellTable", "build_shell_table", "cinterp_shell",
    "sweep_octant_source_batch", "sweep_pyramid_source_batch",
    "sweep_sources_accumulate",
    "RateGrids", "SourceFields", "SweepConfig",
]
