"""Grouped expert matmul (GMM): launcher of ``csrc/moe_gmm.cu``.

Counterpart of the reference ``kernels/moe_gmm.py`` (``gmm_pallas``).  The
plain version is ``ref.gmm_ref``; ``ops.gmm`` picks between the two by the
tensor's device and counts launches.  ``pad_groups`` (host-side regrouping)
is not on the training path and is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "moe_gmm.cu"
SYMBOL = "repro_gmm_bf16"
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def gmm_cuda(lib: ctypes.CDLL, lhs: torch.Tensor, rhs: torch.Tensor,
             expert_map: torch.Tensor, *, block_m: int) -> torch.Tensor:
    """lhs: (M, K) rows grouped by expert in blocks of ``block_m``;
    rhs: (E, K, N); expert_map: (M // block_m,) int32.  Returns (M, N)."""
    for name, t, dtype in (("lhs", lhs, torch.bfloat16),
                           ("rhs", rhs, torch.bfloat16),
                           ("expert_map", expert_map, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"gmm kernel: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != lhs.device:
            raise ValueError(f"gmm kernel: {name} on {t.device}, "
                             f"lhs on {lhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"gmm kernel: {name} must be contiguous")
    M, K = lhs.shape
    E, K2, N = rhs.shape
    if K != K2:
        raise ValueError(f"gmm kernel: lhs K={K}, rhs K={K2}")
    if block_m <= 0 or M % block_m:
        raise ValueError(f"gmm kernel: M={M} is not a multiple of "
                         f"block_m={block_m}")
    if tuple(expert_map.shape) != (M // block_m,):
        raise ValueError(f"gmm kernel: expert_map {tuple(expert_map.shape)} "
                         f"for {M // block_m} row blocks")
    if K % 8 or N % 8 or lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError(f"gmm kernel: K={K} and N={N} must be multiples of 8 "
                         "and the operands 16-byte aligned")
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    rc = getattr(lib, SYMBOL)(lhs.data_ptr(), rhs.data_ptr(),
                              expert_map.data_ptr(), out.data_ptr(),
                              M, K, N, E, block_m, stream)
    if rc:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {rc}")
    return out
