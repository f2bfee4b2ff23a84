"""Matrix-PIC on PyTorch and CUDA: the port of `repro` (JAX/Pallas) to an
NVIDIA Hopper GPU.

The layout mirrors `repro` module for module (`core`, `kernels`, `pic`,
`api`, `launch`), so every function has a counterpart of the same name in
the reference package. The hot contractions run through hand-written CUDA
kernels (`csrc/`, built on first use with `nvcc` and bound with `ctypes`);
every kernel keeps a plain PyTorch version beside it, which is what runs on
a CPU tensor.

This package never imports JAX or `repro`.
"""
