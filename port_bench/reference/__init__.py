"""Plain PyTorch references: no kernel of the program, nothing of
``petal_decomposition_tpu_torch`` or of the JAX package, float32 products
with TF32 off."""
