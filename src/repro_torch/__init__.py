"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports
nothing from it (and never JAX) and keeps its own copies of what it
needs.  Module names follow ``repro``.  Every Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under ``kernels/csrc``; each
kernel wrapper launches it for CUDA tensors and runs its plain PyTorch
version for CPU tensors.  Entry points take ``device=`` (default
``"cuda"``) and raise when CUDA is absent unless given ``device="cpu"``.
"""
