"""Fused deposition kernels: CUDA launcher, wrappers, plain version."""
