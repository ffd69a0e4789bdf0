"""Model notation and the recompute policy (copies of what the port needs
from the numpy-only ``repro.core``)."""

from .notation import (AttentionKind, FamilyKind, MLASpec, MlpKind, MoESpec,
                       ModelSpec)
from .parallel_config import RecomputePolicy

__all__ = ["AttentionKind", "FamilyKind", "MLASpec", "MlpKind", "MoESpec",
           "ModelSpec", "RecomputePolicy"]
