"""Plain PyTorch versions of the three kernels.

They follow the reference package's ``kernels/ref.py`` line for line.  The
wrappers in ``ops`` run them for CPU tensors, the models' backward passes
re-derive their gradients from them, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                gemma_style: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = scale.float()
    if gemma_style:
        g = 1.0 + g
    return (y * g).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """Naive softmax attention. q/k: (b,s,nh,dq), v: (b,s,nh,dv)."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor, expert_map: torch.Tensor,
            *, block_m: int = 128) -> torch.Tensor:
    """Row-block-wise grouped matmul: block i of ``block_m`` rows of ``lhs``
    times ``rhs[expert_map[i]]``, in fp32, cast to ``lhs.dtype``."""
    M, _ = lhs.shape
    out = []
    for blk, e in enumerate(expert_map.tolist()[:M // block_m]):
        xb = lhs[blk * block_m:(blk + 1) * block_m].float()
        out.append((xb @ rhs[e].float()).to(lhs.dtype))
    return torch.cat(out, dim=0)
