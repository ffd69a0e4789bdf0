"""Architecture configs the port runs: ``get_spec(name, smoke=False)``."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.notation import ModelSpec

ARCHS: List[str] = ["deepseek_v3"]


def canonical(name: str) -> str:
    key = name.strip().lower().replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    raise KeyError(f"unknown architecture {name!r}; the port has {ARCHS}")


def get_spec(name: str, smoke: bool = False) -> ModelSpec:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE if smoke else mod.SPEC
