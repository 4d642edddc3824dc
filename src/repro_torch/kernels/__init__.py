"""Hand-written Hopper kernels. Each family holds a plain PyTorch ``ref.py``
and an ``ops.py`` wrapper that runs the plain version for a CPU tensor and
launches the CUDA kernel (``csrc/``) for a CUDA tensor."""
