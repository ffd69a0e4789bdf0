"""Shared building blocks: RMSNorm, RoPE, the SwiGLU MLP, embedding/head.

Parameters live in small ``nn.Module``s whose attribute names are the
reference pytree's keys (``scale``, ``gate``/``up``/``down``, ``w``) and
whose weights keep the reference's ``(in, out)`` orientation, so ``x @ w``
needs no transpose.  The math is in plain functions over those modules.

Dtype discipline (paper Table 7): weights/activations bf16, reductions
(norm statistics, softmax, loss) in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.notation import MlpKind, ModelSpec
from repro_torch.kernels.ref import rmsnorm_ref

_INIT_CHUNK = 1 << 26   # elements drawn at a time, bounds the fp32 scratch


def param(shape: Tuple[int, ...], dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    """An uninitialised parameter; ``Model.init`` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def dense_init(t: torch.Tensor, generator: torch.Generator,
               scale: Optional[float] = None) -> None:
    """Fill ``t`` in place with N(0, 1) * scale drawn in fp32, then cast to
    ``t.dtype``.  The default scale is ``shape[0] ** -0.5``, the reference's
    ``fan_in`` — for stacked expert weights (E, h, f) that is E**-0.5."""
    s = scale if scale is not None else t.shape[0] ** -0.5
    rows = max(1, _INIT_CHUNK // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        part = t[i:i + rows]
        draw = torch.randn(part.shape, generator=generator,
                           dtype=torch.float32, device=t.device)
        part.copy_(draw.mul_(s))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """The reference's ``rmsnorm_init``: gain ``scale`` at one."""

    def __init__(self, h: int, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(h, dtype=dtype, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6,
            gemma_style: bool = False) -> torch.Tensor:
    """Gemma parameterises the gain as (1 + scale); others as scale.  The
    same math as the kernel's plain version."""
    return rmsnorm_ref(x, p.scale, eps=eps, gemma_style=gemma_style)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, n_heads, d); positions: (..., seq).  Split-half form:
    the first and second halves of the head dim are the rotated pair."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (d/2,)
    angles = positions[..., None].float() * freqs              # (..., s, d/2)
    cos = torch.cos(angles)[..., None, :]                      # broadcast heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The reference's ``mlp_init`` (SwiGLU): gate, up (h, d_ff), down."""

    def __init__(self, spec: ModelSpec, d_ff: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if spec.mlp != MlpKind.SWIGLU:
            raise NotImplementedError(f"mlp={spec.mlp.value}: the port has "
                                      "SwiGLU only")
        self.gate = param((spec.h, d_ff), dtype, device)
        self.up = param((spec.h, d_ff), dtype, device)
        self.down = param((d_ff, spec.h), dtype, device)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.gate) * (x @ p.up)) @ p.down


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """The reference's ``embed_init``: (vocab, h), N(0, 1/h) by
    ``Model.init``."""

    def __init__(self, vocab: int, h: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = param((vocab, h), dtype, device)


class Head(nn.Module):
    """The reference's ``head_init``: (h, vocab)."""

    def __init__(self, h: int, vocab: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = param((h, vocab), dtype, device)


def embed_apply(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.w[tokens.long()]
