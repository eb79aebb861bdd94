"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built on first use by ``_build``). Each kernel has a plain PyTorch
version beside its wrapper; the wrapper launches the kernel on CUDA
tensors and runs the plain version on CPU tensors."""

from . import murmur3  # noqa: F401
