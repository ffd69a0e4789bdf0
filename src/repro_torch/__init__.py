"""PyTorch/CUDA port of the ``repro`` training path for an NVIDIA H100.

Mirrors the JAX package module for module (``core``, ``configs``, ``data``,
``kernels``, ``models``, ``optim``, ``train``) so each piece has a named
counterpart.  The three Pallas TPU kernels become hand-written CUDA C++
kernels for ``sm_90a`` (``kernels/csrc``), each beside a plain PyTorch
version.  The package imports torch, numpy and the standard library only.
"""
