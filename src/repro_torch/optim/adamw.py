"""AdamW with the paper's mixed-precision state layout (Table 7):

  weights   BF16  (2 B)   — the live parameters used by forward/backward
  gradients FP32  (4 B)   — the accumulation buffer across micro-batches
  optimizer:
    master copy  FP32 (4 B)
    momentum     BF16 (2 B)
    variance     BF16 (2 B)

The math is the reference's ``optim/adamw.py``: global-norm clip, bias
correction, decoupled weight decay on the fp32 master, m/v rounded to bf16
after the update and the live weights re-cast from the master.  Unlike the
reference's pure function, ``adamw_update`` updates the state in place —
master, m, v, the live parameters, and the fp32 grads used as scratch — so
a full-width state is not held twice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


@dataclasses.dataclass
class TrainState:
    step: int          # optimizer steps taken
    params: Tensors    # bf16 live weights (the model's own parameters)
    master: Tensors    # fp32 copy (optimizer)
    m: Tensors         # bf16 momentum
    v: Tensors         # bf16 variance


@torch.no_grad()
def init_train_state(params: Tensors) -> TrainState:
    return TrainState(
        step=0,
        params=params,
        master={k: p.detach().float().clone() for k, p in params.items()},
        m={k: torch.zeros_like(p, dtype=torch.bfloat16)
           for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.bfloat16)
           for k, p in params.items()},
    )


def global_norm(tensors: Tensors) -> torch.Tensor:
    """fp32 L2 norm over every tensor."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(state: TrainState, grads: Tensors, cfg: AdamWConfig
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """grads: fp32 (the Table-7 accumulation buffer); overwritten."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    for name, g in grads.items():
        master = state.master[name]
        g.mul_(clip)
        m32 = state.m[name].float().mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32 = state.v[name].float().mul_(cfg.b2) \
            .addcmul_(g, g, value=1 - cfg.b2)
        state.m[name].copy_(m32)
        state.v[name].copy_(v32)
        # mh / (sqrt(vh) + eps) + wd * master, built in m32's storage
        upd = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(cfg.eps))
        upd.add_(master, alpha=cfg.weight_decay)
        master.add_(upd, alpha=-cfg.lr)
        state.params[name].copy_(master)
    state.step = step
    return state, {"grad_norm": gnorm}
