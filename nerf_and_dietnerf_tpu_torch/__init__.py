"""PyTorch / CUDA port of ``nerf_and_dietnerf_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside it is the reference this port is held against. The
module layout and names follow it; the radiance MLP's forward and backward
run as hand-written CUDA kernels (``ops/raymarch_cuda.py``, ``csrc/``).
"""
