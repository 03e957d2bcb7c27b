"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: K1 ``sketch_kernel``, K2 ``jacobi_kernels``, K3
``jacobi_f64_kernel``, K4 ``ica_update`` (FastICA's step update), K5
``gram_syrk`` (the float32 Gram) and K6 ``ica_sums`` (FastICA's step
sums over X₁)."""
