"""SPMD parallel iterations over torch.distributed (one rank per device).

Port of ``c2ray_tpu/parallel``: the source-parallel mode of the
reference's MPI model (`sharding.py`) and the x-slab domain
decomposition (`domain.py`), with the collectives of `comm.py` and the
rank-local kernels of `halo.py`; `launch.py` starts the ranks.
"""

from .domain import (domain_evolve3d, gather_state_slabs,
                     group_sources_balanced, group_sources_by_slab,
                     make_domain_iteration, max_domain_radius,
                     shard_state_slabs)
from .sharding import (ParallelConfig, make_parallel_iteration,
                       pad_sources, parallel_evolve3d)

__all__ = ["ParallelConfig", "make_parallel_iteration", "pad_sources",
           "parallel_evolve3d", "domain_evolve3d", "gather_state_slabs",
           "group_sources_balanced", "group_sources_by_slab",
           "make_domain_iteration", "max_domain_radius",
           "shard_state_slabs"]
