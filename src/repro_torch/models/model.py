"""The public model API: ``build_model(spec) -> Model``.

``Model`` is an ``nn.Module`` whose parameter names are the reference
pytree's paths with the stacked layer dim unrolled
(``embed.w``, ``dense_layers.0.attn.w_dq``, ``moe_layers.0.moe.we_gate``,
``final_norm.scale``, ``head.w``).  It holds the training forward and loss
(next-token CE + 0.01 · MoE aux); decode waits for its slice.

Device rule: ``build_model`` places the model on ``"cuda"`` unless the
caller passes ``device="cpu"``; with no card and no explicit device it
raises rather than carry on on the CPU.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.notation import ModelSpec
from .layers import (Embed, Head, RMSNorm, dense_init, embed_apply, rmsnorm)
from .transformer import Block, ModelOptions, stack_apply


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card; it is an error if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: repro_torch runs on an NVIDIA "
                               "GPU; pass device='cpu' to run the plain "
                               "PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


class Model(nn.Module):
    def __init__(self, spec: ModelSpec, opts: ModelOptions, *,
                 device: torch.device, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.spec, self.opts = spec, opts
        n_moe = spec.n_moe_layers()
        kw = dict(dtype=dtype, device=device)
        self.embed = Embed(spec.vocab, spec.h, **kw)
        self.dense_layers = nn.ModuleList(
            Block(spec, False, **kw) for _ in range(spec.n_layers - n_moe))
        self.moe_layers = nn.ModuleList(
            Block(spec, True, **kw) for _ in range(n_moe))
        self.final_norm = RMSNorm(spec.h, **kw)
        if not spec.tie_embeddings:
            self.head = Head(spec.h, spec.vocab, **kw)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init(self, seed: Union[int, torch.Generator] = 0) -> "Model":
        """The port's own initialisation, with the reference's
        distributions: norms at one, the embedding N(0, 1/h), every other
        weight (the fp32 router included) N(0, 1/shape[0])."""
        dev = next(self.parameters()).device
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".scale"):          # every RMSNorm gain
                p.fill_(1.0)
            elif name == "embed.w":
                dense_init(p, gen, scale=self.spec.h ** -0.5)
            else:
                dense_init(p, gen)
        return self

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> "Model":
        """Copy a full name -> tensor map (e.g. ``convert.params_from_jax``)
        into the parameters, casting to each parameter's dtype."""
        own = dict(self.named_parameters())
        if set(own) != set(params):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(params))}, unexpected "
                           f"{sorted(set(params) - set(own))}")
        for name, p in own.items():
            if tuple(params[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(params[name].shape)} "
                                 f"for parameter {tuple(p.shape)}")
            p.copy_(params[name])
        return self

    def with_options(self, opts: ModelOptions) -> "Model":
        """The same parameters under other options (e.g. another backend)."""
        other = copy.copy(self)
        other.opts = opts
        return other

    # ------------------------------------------------------------------
    # training forward / loss
    # ------------------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: tokens (b, s) int.  Returns (logits (b, s, v) in the
        weights' dtype, aux_loss fp32)."""
        spec, opts = self.spec, self.opts
        tokens = batch["tokens"]
        b, s_len = tokens.shape
        x = embed_apply(self.embed, tokens)
        positions = torch.arange(s_len, device=x.device)[None].expand(b, s_len)
        # MLA attention has no sliding window (as in the reference)
        x, aux1 = stack_apply(self.dense_layers, spec, opts, x, positions,
                              False)
        x, aux2 = stack_apply(self.moe_layers, spec, opts, x, positions, True)
        # the plain norm, as in the reference forward (not a kernel call)
        x = rmsnorm(self.final_norm, x, spec.norm_eps,
                    gemma_style=spec.name.startswith("gemma"))
        w = self.embed.w.T if spec.tie_embeddings else self.head.w
        return x @ w, aux1 + aux2

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = self.forward(batch)
        tokens = batch["tokens"]
        targets = tokens[:, 1:].long()
        lg = logits[:, :-1].float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, targets[..., None])[..., 0]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(targets, dtype=torch.float32)
        elif mask.shape == tokens.shape:
            mask = mask[:, 1:]
        ce = torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "loss": total}


def build_model(spec: ModelSpec, opts: Optional[ModelOptions] = None, *,
                device: Union[str, torch.device, None] = None,
                dtype: torch.dtype = torch.bfloat16) -> Model:
    """Allocate the model (uninitialised: call ``init`` or ``load_params``)
    on ``device`` — the card unless the caller asks for the CPU."""
    return Model(spec, opts or ModelOptions(), device=resolve_device(device),
                 dtype=dtype)
