"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: K1 ``sketch_kernel``, K2 ``jacobi_kernels``, K3
``jacobi_f64_kernel`` and K4 ``ica_update`` (FastICA's step update)."""
