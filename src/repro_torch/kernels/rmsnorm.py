"""RMSNorm: launcher of the CUDA kernel in ``csrc/rmsnorm.cu``.

Counterpart of the reference ``kernels/rmsnorm.py`` (``rmsnorm_pallas``).
The plain version is ``ref.rmsnorm_ref``; ``ops.rmsnorm`` picks between
the two by the tensor's device and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "rmsnorm.cu"
SYMBOL = "repro_rmsnorm_bf16"
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]


def rmsnorm_cuda(lib: ctypes.CDLL, x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float, gemma_style: bool) -> torch.Tensor:
    """x: (..., h) bf16, contiguous, on a CUDA device; scale: (h,) bf16."""
    h = x.shape[-1]
    for name, t in (("x", x), ("scale", scale)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"rmsnorm kernel: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"rmsnorm kernel: {name} on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm kernel: {name} must be contiguous")
    if tuple(scale.shape) != (h,):
        raise ValueError(f"rmsnorm kernel: scale {tuple(scale.shape)} "
                         f"for rows of width {h}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, SYMBOL)(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                              x.numel() // max(h, 1), h, float(eps),
                              int(bool(gemma_style)), stream)
    if rc:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    return out
