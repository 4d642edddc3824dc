"""PyTorch/CUDA port of the StraightLine serving stack.

Mirrors ``src/repro/`` module for module. Plain tensor code is PyTorch; every
kernel that the JAX package writes in Pallas is a hand-written CUDA kernel
for Hopper (``kernels/csrc/``), built with ``nvcc`` on first use. Importing
this package imports neither JAX nor anything of the JAX package.
"""
