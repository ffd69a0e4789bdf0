"""Activation-recomputation policy (paper §5: AC None / Full / Selective)."""

from __future__ import annotations

import enum


class RecomputePolicy(enum.Enum):
    NONE = "none"          # store all intermediate activations
    FULL = "full"          # store only per-block inputs
    SELECTIVE = "selective"  # store all but attention-score/softmax & expert ffn internals
