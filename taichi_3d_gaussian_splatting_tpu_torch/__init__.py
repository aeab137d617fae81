"""PyTorch + CUDA port of the Gaussian-splatting renderer for NVIDIA Hopper.

Sub-packages mirror ``taichi_3d_gaussian_splatting_tpu`` module for module
(``ops/``, ``models/``, ``apps/``), so every file here has one JAX
counterpart to be checked against. The JAX package stays the reference;
nothing here imports it (or JAX).

The kernels of the render path are hand-written CUDA C++ under ``csrc/``,
compiled with ``nvcc`` for ``sm_90a`` on first use (``ops/cuda_build.py``).
Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel (or raises) for CUDA tensors.
"""
