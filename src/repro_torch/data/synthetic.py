"""Deterministic synthetic token pipeline.

The same generator as the reference ``data/synthetic.py``: a numpy
``SeedSequence([seed, step])`` drives Zipfian unigrams plus copy-from-8-back
structure, so a batch is identical, token for token, in both packages.
Only the final conversion differs: batches are torch tensors on the
caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    zipf_alpha: float = 1.1
    repeat_prob: float = 0.3      # p(copy token from 8 back) — learnable signal


def _zipf_logits(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return np.log(p / p.sum())


def make_batch(cfg: SyntheticConfig, step: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """{"tokens": (batch, seq_len) int32} for ``step`` on ``device``."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    probs = np.exp(_zipf_logits(cfg.vocab, cfg.zipf_alpha))
    toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len), p=probs)
    # inject copy structure: with prob repeat_prob, token = token[t-8]
    mask = rng.random((cfg.batch, cfg.seq_len)) < cfg.repeat_prob
    mask[:, :8] = False
    shifted = np.roll(toks, 8, axis=1)
    toks = np.where(mask, shifted, toks).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


def batches(cfg: SyntheticConfig, device: torch.device,
            n_steps: Optional[int] = None
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = 0
    while n_steps is None or step < n_steps:
        yield make_batch(cfg, step, device)
        step += 1
