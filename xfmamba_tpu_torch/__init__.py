"""PyTorch port of xfmamba_tpu for NVIDIA Hopper (H100).

The JAX package ``xfmamba_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``checkpoint/``) and replaces its Pallas TPU
kernels with hand-written CUDA kernels (``csrc/``, built and bound by
``kernels/``).  Public functions keep the JAX layout, channels-last
``(B, H, W, C)``.  Importing the package builds nothing and imports no JAX.
"""
