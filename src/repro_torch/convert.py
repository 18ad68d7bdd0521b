"""Carry a JAX-side parameter tree into the port's parameter layout.

``params_from_numpy(cfg, tree, device)`` takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``, built by the caller) and returns the port's dict: the same keys,
with the per-period stacks of ``tree["blocks"]`` unstacked into one dict per
layer (and an encoder-decoder's ``enc_blocks`` and ``dec_blocks``, each one
dict stacked over layers, unstacked the same way with a period of 1). bf16,
e4m3 and e5m2 leaves (numpy dtype names ``bfloat16``, ``float8_e4m3fn``,
``float8_e5m2``) travel as their raw bit patterns, so no numpy extension for
them is needed here; every other leaf keeps its
dtype (a bf16 model's norms, mamba's ``A_log``, ``D`` and ``dt_bias`` and
the xLSTM gate biases stay fp32).

``params_to_numpy(cfg, params)`` goes the other way, for any tree in the
port's layout (parameters, gradients, optimizer moments): every leaf to
numpy and the per-layer dicts restacked over periods, so that two trees can
be compared leaf by leaf. Numpy has no bf16 or 8-bit float of its own, so
such leaves come back widened to fp32, which is exact.

``stack_blocks`` and ``unstack_blocks`` hold that mapping between the port's
per-layer ``blocks`` list and the reference's per-pattern-position stacks,
with the leaf conversion left to the caller (:mod:`repro_torch.checkpoint`
keeps bf16 bits where this module widens them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import check_supported
from repro_torch.tree import map_leaves

__all__ = ["tensor_from_numpy", "params_from_numpy", "params_to_numpy", "stack_blocks",
           "unstack_blocks"]


# ml_dtypes' narrow floats by numpy dtype name: (the raw pattern's integer
# type, the torch dtype viewed over it). No import of ml_dtypes is needed.
_RAW_FLOATS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(x, device) -> torch.Tensor:
    """One numpy array (bf16, e4m3 and e5m2 included, each carried as its
    bit pattern) as a tensor on ``device``."""
    x = np.array(x, copy=True, order="C")  # owned and writable: no aliasing
    raw = _RAW_FLOATS.get(x.dtype.name)
    if raw is not None:
        return torch.from_numpy(x.view(raw[0])).view(raw[1]).to(device)
    return torch.from_numpy(x).to(device)


def _layer_stacks(cfg: ArchConfig) -> Dict[str, int]:
    """An encoder-decoder's ``enc_blocks`` and ``dec_blocks``, each one dict
    stacked over its layers, with their numbers of layers."""
    return {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers} if cfg.is_encdec else {}


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's numpy parameter tree as the port's parameters."""
    check_supported(cfg)
    device = torch.device(device)
    stacks = _layer_stacks(cfg)
    take = lambda x, period: tensor_from_numpy(np.asarray(x)[period], device)  # noqa: E731
    out = {k: map_leaves(lambda x: tensor_from_numpy(x, device), v)
           for k, v in tree.items() if k != "blocks" and k not in stacks}
    if "blocks" in tree:
        out["blocks"] = unstack_blocks(tree["blocks"], cfg.n_periods, take)
    for k, n_layers in stacks.items():
        out[k] = unstack_blocks((tree[k],), n_layers, take)
    return out


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    narrow = x.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
    return (x.float() if narrow else x).numpy()


def params_to_numpy(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """A tree in the port's layout as the reference's numpy tree: the
    inverse of :func:`params_from_numpy` (bf16 leaves widened to fp32)."""
    check_supported(cfg)
    stacks = _layer_stacks(cfg)
    stack = lambda xs: np.stack([_to_numpy(t) for t in xs])  # noqa: E731
    out = {k: map_leaves(_to_numpy, v) for k, v in params.items()
           if k != "blocks" and k not in stacks}
    if "blocks" in params:
        out["blocks"] = stack_blocks(params["blocks"], len(cfg.pattern), stack)
    for k in stacks:
        out[k] = stack_blocks(params[k], 1, stack)[0]
    return out


def stack_blocks(blocks: List[Any], period: int, stack: Callable[[List[Any]], Any]) -> tuple:
    """The port's per-layer ``blocks`` as the reference's tuple of stacks,
    one per pattern position (``period`` of them), each leaf
    ``stack(its per-period leaves)``."""
    n_periods = len(blocks) // period
    return tuple(_stack([blocks[i * period + pos] for i in range(n_periods)], stack)
                 for pos in range(period))


def unstack_blocks(stacks: tuple, n_periods: int, take: Callable[[Any, int], Any]) -> List[Any]:
    """The inverse of :func:`stack_blocks`: one dict per layer, each leaf
    ``take(stacked_leaf, period)``."""
    return [map_leaves(lambda x: take(x, period), stacks[pos])
            for period in range(n_periods) for pos in range(len(stacks))]


def _stack(trees: List[Any], stack: Callable[[List[Any]], Any]) -> Any:
    """Leaf-wise ``stack`` of same-structured trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], stack) for k in first}
    return stack(trees)
