"""PyTorch/CUDA port of imagecaptioner_tpu for one NVIDIA H100.

The JAX package ``imagecaptioner_tpu`` stays the reference; this package
keeps its module names so each counterpart is easy to find.  It imports
torch and numpy only (never jax, never the JAX package): the machine that
serves it has neither jax, pandas nor PIL installed.

Hand-written Hopper kernels live in ``csrc/`` and are built with nvcc at
first use into ``_build/`` (``ops/_build.py``).
"""
