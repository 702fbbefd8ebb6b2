"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper.

Imports ``torch``, NumPy and the standard library, never ``jax`` or
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``; every kernel that ``repro`` wrote in Pallas for the TPU
is a hand-written CUDA kernel here (``repro_torch.kernels``).
"""
