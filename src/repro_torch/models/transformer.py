"""Transformer block composition and the layer stack.

Layers are a ``ModuleList`` of ``Block``s run by a Python loop (PyTorch is
eager: the reference's ``lax.scan`` has no counterpart to keep).  The
activation-recomputation policy (paper §5: AC None / Full / Selective) is
applied per block: FULL is ``torch.utils.checkpoint`` without reentrancy.
SELECTIVE and partial recompute (``recompute_fraction < 1``) are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.notation import AttentionKind, ModelSpec
from repro_torch.core.parallel_config import RecomputePolicy
from . import backend as B
from . import mla as M
from . import moe as E
from .layers import MLP, RMSNorm, mlp_apply


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    attn_impl: str = "naive"          # "naive" | "flash" (the CUDA kernel)
    capacity_factor: float = 1.25
    recompute: RecomputePolicy = RecomputePolicy.NONE
    # Kernel backend for the hot ops (rmsnorm / attention / grouped_mlp):
    # "reference" (plain PyTorch) | "cuda" (the hand-written kernels).
    # "cuda" runs MLA attention through the flash kernel.
    backend: str = "reference"
    router_impl: str = "softmax"      # "softmax" | "sigmoid" (deepseek-v3)
    # paper §5 partial recompute: fraction of each stack the policy covers
    recompute_fraction: float = 1.0


def _norm(p: RMSNorm, x: torch.Tensor, spec: ModelSpec,
          opts: Optional[ModelOptions] = None) -> torch.Tensor:
    gemma = spec.name.startswith("gemma")
    return B.rmsnorm(p, x, spec.norm_eps, gemma_style=gemma,
                     backend=B.resolve_backend(opts))


class Block(nn.Module):
    """The reference's ``block_init``: one layer's ln1, ln2, attn (MLA) and
    moe or mlp; ``Model`` holds them in ``ModuleList``s where the reference
    stacks them (``stack_init``)."""

    def __init__(self, spec: ModelSpec, is_moe_layer: bool, *,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        if spec.attention != AttentionKind.MLA:
            raise NotImplementedError(f"attention={spec.attention.value}: "
                                      "the port has MLA only")
        self.ln1 = RMSNorm(spec.h, dtype=dtype, device=device)
        self.ln2 = RMSNorm(spec.h, dtype=dtype, device=device)
        self.attn = M.MLA(spec, dtype=dtype, device=device)
        if is_moe_layer:
            self.moe = E.MoE(spec, dtype=dtype, device=device)
        elif spec.h_ff:
            self.mlp = MLP(spec, spec.h_ff, dtype=dtype, device=device)


def block_apply(p: Block, spec: ModelSpec, opts: ModelOptions,
                x: torch.Tensor, positions: torch.Tensor,
                is_moe_layer: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer layer; returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(p.ln1, x, spec, opts)
    backend = B.resolve_backend(opts)
    x = x + M.mla_forward(p.attn, spec, h, positions,
                          impl=B.resolve_attn_impl(opts),
                          backend=backend)

    h2 = _norm(p.ln2, x, spec, opts)
    if is_moe_layer:
        out = E.moe_forward(p.moe, spec, h2,
                            capacity_factor=opts.capacity_factor,
                            router_impl=opts.router_impl, backend=backend)
        x = x + out.y
        aux = aux + out.aux_loss
    elif spec.h_ff:
        x = x + mlp_apply(p.mlp, h2)
    return x, aux


def stack_apply(layers: nn.ModuleList, spec: ModelSpec, opts: ModelOptions,
                x: torch.Tensor, positions: torch.Tensor, is_moe: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer group in order with the recompute policy applied."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if opts.recompute == RecomputePolicy.SELECTIVE:
        raise NotImplementedError("RecomputePolicy.SELECTIVE is not ported "
                                  "yet")
    if opts.recompute != RecomputePolicy.NONE and opts.recompute_fraction < 1:
        raise NotImplementedError("partial recompute (recompute_fraction < 1)"
                                  " is not ported yet")
    full = opts.recompute == RecomputePolicy.FULL
    for layer in layers:
        if full:
            x, a = checkpoint(block_apply, layer, spec, opts, x, positions,
                              is_moe, use_reentrant=False)
        else:
            x, a = block_apply(layer, spec, opts, x, positions, is_moe)
        aux = aux + a
    return x, aux
