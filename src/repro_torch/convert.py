"""Carry a JAX-side parameter tree into the port's parameter layout.

``params_from_numpy(cfg, tree, device)`` takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``, built by the caller) and returns the port's dict: the same keys,
with the per-period stacks of ``tree["blocks"]`` unstacked into one dict per
layer. bf16 leaves (numpy dtype name ``bfloat16``) travel as their raw 16-bit
patterns, so no bf16-aware numpy extension is needed here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import check_supported

__all__ = ["tensor_from_numpy", "params_from_numpy"]


def tensor_from_numpy(x, device) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``."""
    x = np.array(x, copy=True, order="C")  # owned and writable: no aliasing
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's numpy parameter tree as the port's parameters."""
    check_supported(cfg)
    device = torch.device(device)
    out = {k: _map(v, lambda x: tensor_from_numpy(x, device))
           for k, v in tree.items() if k != "blocks"}
    stacks = tree["blocks"]  # one stacked dict per pattern position
    blocks: List[Dict[str, Any]] = []
    for period in range(cfg.n_periods):
        for pos in range(len(cfg.pattern)):
            blocks.append(
                _map(stacks[pos], lambda x: tensor_from_numpy(np.asarray(x)[period], device))
            )
    out["blocks"] = blocks
    return out
