"""PyTorch / CUDA port of the JAX training package for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps its
counterpart's name and is held against it by ``tests/test_torch_*.py``.  This
package imports ``torch`` and never ``jax``, nor anything of the JAX package.
Its flash-attention kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, built
with ``nvcc`` at first use.
"""
