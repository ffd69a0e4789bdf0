"""Flash attention with dq != dv: launcher of ``csrc/mla_attention.cu``.

Counterpart of the reference ``kernels/mla_attention.py``
(``flash_attention_pallas``).  The kernel reads q/k/v in their
(b, s, n_h, d) layout through strides, so unlike the TPU path no transpose
or padding copy is made here.  The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between the two
by the tensor's device and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "mla_attention.cu"
SYMBOL = "repro_flash_attention_bf16"
_STRIDES = ctypes.c_longlong * 3
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.POINTER(ctypes.c_longlong)] * 4 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

MAX_HEAD_DIM = 256      # shared-memory layout limit of the kernel
_MAX_GRID_Y = 65535     # b * n_h runs on the grid's y dimension


def _strides(name: str, t: torch.Tensor):
    sb, ss, sh, sd = t.stride()
    if sd != 1:
        raise ValueError(f"flash kernel: {name} head dim must be contiguous")
    if any(st % 8 for st in (sb, ss, sh)) or t.data_ptr() % 16:
        raise ValueError(f"flash kernel: {name} rows must be 16-byte aligned "
                         f"(strides {t.stride()})")
    return _STRIDES(sb, ss, sh)


def flash_attention_cuda(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, scale: float,
                         causal: bool) -> torch.Tensor:
    """q/k: (b, s, n_h, dq); v: (b, s, n_h, dv) -> (b, s, n_h, dv), bf16."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel: {name} must be bfloat16, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"flash kernel: {name} must be (b, s, n_h, d)")
    b, s, nh, dq = q.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (b, s, nh, dq) or tuple(v.shape[:3]) != (b, s, nh):
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, d in (("dq", dq), ("dv", dv)):
        if d % 16 or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(f"flash kernel: {name}={d} must be a multiple of "
                             f"16 in (0, {MAX_HEAD_DIM}]")
    if b * nh > _MAX_GRID_Y:
        raise ValueError(f"flash kernel: b*n_h={b * nh} > {_MAX_GRID_Y}")
    strides = [_strides(name, t) for name, t in (("q", q), ("k", k),
                                                 ("v", v))]
    out = torch.empty((b, s, nh, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, SYMBOL)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, nh, dq, dv, *strides, _strides("out", out), float(scale),
        int(bool(causal)), stream)
    if rc:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {rc}")
    return out
