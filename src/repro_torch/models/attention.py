"""The naive attention path the reference MLA backend falls back to.

Only ``causal_mask`` and ``naive_attention`` are ported: they materialise
(b, n_h, s, s) scores, the paper's 5·b·n_h·s² activation term.  GQA and the
``chunked`` online-softmax path wait for a later slice.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def causal_mask(s: int, device: torch.device) -> torch.Tensor:
    """(s, s) bool, True where key j may be seen by query i (j <= i).  The
    reference's sliding-window variant waits for the GQA slice."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return j <= i


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q:(b,s,nh,dq) k:(b,s,nh,dq) v:(b,s,nh,dv) mask:(s,s) -> (b,s,nh,dv).
    Scores in the input dtype, softmax in fp32, probs cast back."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = torch.where(mask, scores.float(),
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
