"""Fused gather kernel: CUDA launcher, wrapper, plain version."""
