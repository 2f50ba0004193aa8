"""PyTorch/CUDA port of ``repro``: mixed-precision neural operators on an
NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module and imports none of it.  Entry points run on
the card unless the caller passes ``device="cpu"``.  Kernels are written
by hand for Hopper (``repro_torch/kernels/csrc``); on CPU tensors each
kernel wrapper runs its plain PyTorch version.
"""
