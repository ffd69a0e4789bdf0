"""Training loop: micro-batched gradient accumulation (fp32 buffers, the
paper's Table-7 gradient dtype), AdamW update, metrics.

``make_train_step`` builds the step: the global batch is split into
``n_micro`` micro-batches along the batch dim, each one's bf16 gradients
are added into fp32 buffers, the sum is divided by ``n_micro``, and one
optimizer update follows.  The step differentiates the model's own
parameters, so ``state.params`` must be ``dict(model.named_parameters())``
(what ``train`` builds).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWConfig, TrainState, adamw_update,
                                     init_train_state)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1              # grad-accumulation steps per train step
    adamw: AdamWConfig = AdamWConfig()


def _split_micro(batch: Batch, n_micro: int) -> List[Batch]:
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    parts = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n_micro)]


def make_train_step(model: Model, cfg: TrainConfig
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    def train_step(state: TrainState, batch: Batch):
        names = list(state.params)
        params = [state.params[n] for n in names]
        grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in zip(names, params)}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        for mb in _split_micro(batch, cfg.n_micro):
            loss, _ = model.loss(mb)
            g = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for n, gi in zip(names, g):
                    grads[n].add_(gi)
                loss_sum += loss.detach()
            del g
        for acc in grads.values():
            acc.div_(cfg.n_micro)
        new_state, opt_metrics = adamw_update(state, grads, cfg.adamw)
        return new_state, {"loss": loss_sum / cfg.n_micro, **opt_metrics}

    return train_step


def train(model: Model, batches: Iterable[Batch], n_steps: int,
          cfg: Optional[TrainConfig] = None, log_every: int = 10,
          state: Optional[TrainState] = None,
          callback: Optional[Callable[[int, Dict], None]] = None
          ) -> Tuple[TrainState, list]:
    """Single-device loop: ``n_steps`` steps on the model's own device
    (initialise the model first: ``build_model(...).init(seed)``)."""
    cfg = cfg or TrainConfig()
    if state is None:
        state = init_train_state(dict(model.named_parameters()))
    step_fn = make_train_step(model, cfg)
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= n_steps:
            break
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(i, m)
    return state, history
