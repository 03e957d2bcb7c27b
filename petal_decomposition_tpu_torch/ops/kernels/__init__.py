"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: K1 ``sketch_kernel``, K2 ``jacobi_kernels`` and K3
``jacobi_f64_kernel``."""
