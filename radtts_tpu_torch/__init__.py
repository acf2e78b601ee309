"""PyTorch/CUDA port of radtts_tpu for NVIDIA Hopper.

The JAX package `radtts_tpu` is the reference; this package imports nothing
of it (nor JAX) and keeps the JAX package's module layout and names, with
channels-last (B, T, C) tensors at every public function.
"""
