"""Mixture-of-experts layer (paper §1.1/§3.3/§5.2), the single-device path.

Capacity-based token dispatch from sort/scatter primitives: the expert
buffer is (E, C, h) with C = round(T·K/E·cf), filled by a scatter-add of
each kept (token, expert) assignment at its rank within the expert.
Expert parallelism (the reference's ``_moe_forward_ep``) waits for the
distributed slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.notation import ModelSpec
from .layers import MLP, mlp_apply, param


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor       # load-balance auxiliary loss
    router_probs: torch.Tensor   # (T, E) fp32 normalised router probabilities


class MoE(nn.Module):
    """The reference's ``moe_init``: fp32 router (h, E), stacked expert
    weights, and the shared expert."""

    def __init__(self, spec: ModelSpec, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        e = spec.moe
        E, h, f = e.n_routed, spec.h, e.d_ff_expert
        self.router = param((h, E), torch.float32, device)
        # stacked expert weights: leading dim = expert
        self.we_gate = param((E, h, f), dtype, device)
        self.we_up = param((E, h, f), dtype, device)
        self.we_down = param((E, f, h), dtype, device)
        if e.n_shared:
            self.shared = MLP(spec, f * e.n_shared, dtype=dtype, device=device)


def _route(router_w: torch.Tensor, spec: ModelSpec, xt: torch.Tensor,
           router_impl: str
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route flat tokens (T, h) -> (probs (T, E) fp32, gates (T, K) fp32,
    eids (T, K) int64).  DeepSeek-v3 sigmoid scoring + top-k renorm, or
    classic top-k softmax."""
    k = spec.moe.n_active
    logits = xt.float() @ router_w
    if router_impl == "sigmoid":
        scores = torch.sigmoid(logits)
        gate_vals, eids = torch.topk(scores, k, dim=-1)
        gates = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    elif router_impl == "softmax":
        probs = torch.softmax(logits, dim=-1)
        gate_vals, eids = torch.topk(probs, k, dim=-1)
        gates = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20)
    else:
        raise ValueError(f"unknown router_impl {router_impl!r}")
    return probs, gates, eids


def _positions_in_expert(eids: torch.Tensor, n_expert: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For flat expert assignments (TK,), each assignment's rank within its
    expert (in assignment order, by a stable sort) and per-expert totals."""
    tk = eids.shape[0]
    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    counts = torch.bincount(eids, minlength=n_expert)
    offsets = torch.cumsum(counts, 0) - counts           # (E,) group starts
    pos_sorted = torch.arange(tk, device=eids.device) - offsets[sorted_eids]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return pos, counts


def moe_forward(p: MoE, spec: ModelSpec, x: torch.Tensor, *,
                capacity_factor: float = 1.25,
                router_impl: str = "softmax",
                backend: str = "reference") -> MoEOutput:
    """x: (b, s, h) -> (b, s, h)."""
    from .backend import grouped_mlp
    e = spec.moe
    b, s, h = x.shape
    T = b * s
    E, K = e.n_routed, e.n_active
    xt = x.reshape(T, h)

    probs, gates, eids = _route(p.router, spec, xt, router_impl)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = F.one_hot(eids, E).float().sum(1).mean(dim=0) / K
    aux = E * torch.sum(me * ce)

    # Python's round (half to even), as in the reference
    C = int(max(1, round(T * K / E * capacity_factor)))
    flat_eids = eids.reshape(T * K)
    pos, _ = _positions_in_expert(flat_eids, E)
    keep = pos < C
    pos_c = pos.clamp(max=C - 1)

    # dispatch: scatter-add kept tokens into the (E, C, h) buffer; dropped
    # assignments land on slot C-1 as zeros
    src = xt.repeat_interleave(K, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, C, h), dtype=x.dtype, device=x.device) \
        .index_put((flat_eids, pos_c), src, accumulate=True)

    out_buf = grouped_mlp(buf, p.we_gate, p.we_up, p.we_down, backend=backend)

    # combine: gather each assignment's expert output, weight, sum over K
    w = (gates.reshape(T * K) * keep.float())[:, None].to(x.dtype)
    y = (out_buf[flat_eids, pos_c] * w).reshape(T, K, h).sum(dim=1)

    if e.n_shared:
        y = y + mlp_apply(p.shared, xt)
    return MoEOutput(y=y.reshape(b, s, h), aux_loss=aux, router_probs=probs)


def moe_forward_dense_ref(p: MoE, spec: ModelSpec, x: torch.Tensor, *,
                          router_impl: str = "softmax") -> torch.Tensor:
    """Dropless dense reference: every token runs through its top-k experts
    via full (T, E) weighting.  O(T·E·h·f) — for tests on tiny sizes only."""
    e = spec.moe
    b, s, h = x.shape
    T = b * s
    xt = x.reshape(T, h)
    _, gates, eids = _route(p.router, spec, xt, router_impl)
    w = torch.zeros((T, e.n_routed), dtype=torch.float32, device=x.device) \
        .scatter(1, eids, gates)
    a = F.silu(torch.einsum("th,ehf->etf", xt, p.we_gate))
    a = a * torch.einsum("th,ehf->etf", xt, p.we_up)
    ye = torch.einsum("etf,efh->eth", a, p.we_down)       # (E, T, h)
    y = torch.einsum("te,eth->th", w.to(x.dtype), ye)
    if e.n_shared:
        y = y + mlp_apply(p.shared, xt)
    return y.reshape(b, s, h)
