"""PyTorch/CUDA port of the batch-query system, beside the JAX package.

Module layout mirrors ``repro``: ``core`` (hash, NeighborHash builders,
device lookup, the multi-table engine, the hybrid store), ``kernels`` (the
hand-written Hopper probe kernels, their plain PyTorch versions and the
dispatch between them), ``api`` (the FeatureService protocol and client).
The package imports torch and numpy and never JAX or ``repro``.
"""
