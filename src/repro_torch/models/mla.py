"""Multi-Head Latent Attention (DeepSeek-v2/v3), paper §1/§3.2/§5.1 —
the training path.

Query tower (W^DQ → norm → W^UQ/W^QR), latent KV (W^DKV → norm →
W^UK/W^UV), shared rope key W^KR, softmax over concat(nope, rope) dims,
W^O out.  The tensor-parallel entry operator (``tpf``) and the latent-cache
decode of the reference wait for their slices.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.notation import ModelSpec
from . import backend as B
from .layers import RMSNorm, apply_rope, param


class MLA(nn.Module):
    """The reference's ``mla_init``: the tower weights and q/kv norms."""

    def __init__(self, spec: ModelSpec, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        m, h, nh = spec.mla, spec.h, spec.n_h
        self.w_dq = param((h, m.d_cq), dtype, device)
        self.w_uq = param((m.d_cq, nh * m.d_h), dtype, device)
        self.w_qr = param((m.d_cq, nh * m.d_hr), dtype, device)
        self.w_dkv = param((h, m.d_c), dtype, device)
        self.w_uk = param((m.d_c, nh * m.d_h), dtype, device)
        self.w_uv = param((m.d_c, nh * m.d_v), dtype, device)
        self.w_kr = param((h, m.d_hr), dtype, device)
        self.w_o = param((nh * m.d_v, h), dtype, device)
        self.q_norm = RMSNorm(m.d_cq, dtype=dtype, device=device)
        self.kv_norm = RMSNorm(m.d_c, dtype=dtype, device=device)


def _towers(p: MLA, spec: ModelSpec, x: torch.Tensor,
            positions: torch.Tensor, backend: str = "reference"):
    """Returns q (nope‖rope), k (nope‖rope), v as (b, s, n_h, d)."""
    m = spec.mla
    b, s, _ = x.shape
    cq = B.rmsnorm(p.q_norm, x @ p.w_dq, spec.norm_eps, backend=backend)
    q_nope = (cq @ p.w_uq).reshape(b, s, spec.n_h, m.d_h)
    q_rope = apply_rope((cq @ p.w_qr).reshape(b, s, spec.n_h, m.d_hr),
                        positions, spec.rope_theta)
    c_kv = B.rmsnorm(p.kv_norm, x @ p.w_dkv, spec.norm_eps, backend=backend)
    k_nope = (c_kv @ p.w_uk).reshape(b, s, spec.n_h, m.d_h)
    k_rope = apply_rope((x @ p.w_kr).reshape(b, s, 1, m.d_hr),
                        positions, spec.rope_theta)
    k_rope = k_rope.expand(b, s, spec.n_h, m.d_hr)
    v = (c_kv @ p.w_uv).reshape(b, s, spec.n_h, m.d_v)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return q, k, v


def mla_forward(p: MLA, spec: ModelSpec, x: torch.Tensor,
                positions: torch.Tensor, *, impl: str = "naive",
                backend: str = "reference") -> torch.Tensor:
    m = spec.mla
    b, s, _ = x.shape
    q, k, v = _towers(p, spec, x, positions, backend=backend)
    scale = (m.d_h + m.d_hr) ** -0.5
    ctx = B.mla_attention(q, k, v, scale=scale, impl=impl)
    return ctx.reshape(b, s, spec.n_h * m.d_v) @ p.w_o
