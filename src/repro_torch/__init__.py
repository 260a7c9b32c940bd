"""PyTorch/CUDA port of the Apparate reproduction.

A second package beside the JAX package ``repro``, which stays the
reference. It imports torch and numpy, never jax and nothing of ``repro``;
module names mirror ``repro`` so each module's counterpart is easy to find.
Entry points run on the CUDA card unless the caller asks for the CPU.

Packages: ``configs``, ``models`` (the LM, ResNet, BERT, the bridge from
reference pytrees), ``kernels`` (the hand-written CUDA kernels beside
their plain versions), ``core`` and ``serving`` (copies of the
reference's controller and engines, and the runners), ``data``,
``training`` (optimizers, the train loop, ramp training),
``checkpoint`` (the reference's on-disk format) and ``launch`` (``serve``,
``train``).
"""
