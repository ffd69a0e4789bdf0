"""Weights from the reference package into the port's parameter names.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so a parity test initialises once in the reference package, turns the
pytree into numpy arrays, and loads it here.  Nothing here imports JAX: the
input is a nested dict of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# pytree groups whose leaves carry a leading layer dim (stacked layers)
STACKED = ("dense_layers", "moe_layers")


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}.{key}" if prefix else key, out)
    else:
        out[prefix] = np.asarray(tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference ``Model.init`` pytree (numpy leaves) -> ``{port parameter
    name: float32 CPU tensor}``.  ``dense_layers``/``moe_layers`` leaves are
    unstacked along their leading layer dim into ``<group>.<i>.<path>``.
    bf16 leaves pass through float32, which is exact; ``Model.load_params``
    casts back to each parameter's dtype."""
    flat: Dict[str, np.ndarray] = {}
    for group, sub in tree.items():
        if group in STACKED:
            leaves: Dict[str, np.ndarray] = {}
            _flatten(sub, "", leaves)
            for path, arr in leaves.items():
                for i in range(arr.shape[0]):
                    flat[f"{group}.{i}.{path}"] = arr[i]
        else:
            _flatten(sub, group, flat)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32))
            for name, arr in flat.items()}
