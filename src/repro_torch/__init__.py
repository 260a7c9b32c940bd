"""PyTorch/CUDA port of the Apparate reproduction.

A second package beside the JAX package ``repro``, which stays the
reference. It imports torch and numpy, never jax and nothing of ``repro``;
module names mirror ``repro`` so each module's counterpart is easy to find.
Entry points run on the CUDA card unless the caller asks for the CPU.
"""
