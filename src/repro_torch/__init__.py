"""Tardis-PyTorch: the PyTorch + CUDA port of the Tardis serving stack.

Sits beside the JAX package ``repro`` (the reference) with the same layout;
imports nothing of it and nothing of JAX.  Subpackages import lazily and
this file imports nothing heavy, so ``import repro_torch`` works where
there is no GPU, no ``nvcc`` and no ``triton``:
  configs, core, analysis, kernels, models, runtime, launch.
"""
__version__ = "1.0.0"
