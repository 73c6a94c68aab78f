"""c2ray_tpu_torch: the c2ray_tpu radiative transfer in PyTorch and CUDA.

The port of ``c2ray_tpu`` (JAX, written for a TPU) to PyTorch on an
NVIDIA H100.  It mirrors the JAX package's module paths, names and
layouts; the JAX package stays the reference it is tested against.
Plain tensor code is PyTorch; the kernels -- the 3D timestep's three
sweep engines and chemistry fixed point (with heating: the thermal
sub-cycle inside it), the photon-loss redistribution, the 1D program's
radial march and the domain decomposition's halo pack, window add and
halo fold -- are CUDA C++ under ``csrc/``, built with nvcc on first use.
Each has a plain PyTorch version beside it, which CPU tensors take.
``parallel`` runs the timestep over several devices, one process each
(source-parallel or x-slab domain decomposition over
``torch.distributed``).

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
