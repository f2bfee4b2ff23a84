"""Segment accumulation kernel: CUDA launcher, wrapper, plain version."""
