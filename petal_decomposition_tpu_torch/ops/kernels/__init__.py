"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: K1 ``sketch_kernel`` and K2 ``jacobi_kernels``."""
