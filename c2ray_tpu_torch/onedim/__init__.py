from .material import OneDProblem, init_material
from .evolve import OneDContext, State1D, evolve1d
from .analytic import analytic_front, numerical_front

__all__ = [
    "OneDProblem", "init_material",
    "OneDContext", "State1D", "evolve1d",
    "analytic_front", "numerical_front",
]
