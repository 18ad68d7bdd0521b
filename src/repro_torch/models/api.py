"""Model API of the port: init, prefill and decode entry points.

The port of :mod:`repro.models.api` for token-prompt dense and MoE decoders. Decode
state is a list of per-layer :class:`KVCache`. ``init_params`` and
``init_state`` run on ``cuda`` unless the caller passes ``device="cpu"``;
the other entry points run where their tensors are. Their ``backend=`` is a
backend name of :mod:`repro_torch.kernels.ops` or a precision policy
(:class:`repro_torch.quant.PrecisionPolicy`), resolved per layer role.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from . import transformer as tf_mod
from .attention import KVCache

__all__ = [
    "resolve_device",
    "init_params",
    "init_state",
    "prefill",
    "decode",
    "prefill_bucketed",
    "decode_at",
    "param_count",
    "active_param_count",
]


def resolve_device(device=None) -> torch.device:
    """``device`` or, by default, ``cuda``. A CUDA device on a machine
    without one raises; nothing quietly moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def init_params(
    cfg: ArchConfig, generator: Optional[torch.Generator] = None, device=None
) -> Dict[str, Any]:
    """Random parameters on ``device`` (default ``cuda``) in
    ``cfg.param_dtype``, drawn from ``generator`` (a generator on that
    device; seed 0 when omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return tf_mod.init_lm_params(cfg, generator, dev)


def init_state(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> List[KVCache]:
    """Decode caches sized for ``max_len`` positions."""
    return tf_mod.init_caches(cfg, batch, max_len, dtype, resolve_device(device))


def prefill(
    cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], max_len: int,
    cache_dtype=torch.bfloat16, *, backend=None,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Process the full prompt; return (last-token logits [B, V], caches)."""
    tokens = batch["tokens"]
    caches = tf_mod.init_caches(cfg, tokens.shape[0], max_len, cache_dtype, tokens.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, tokens, cfg, mode="prefill", caches=caches, backend=backend
    )
    return tf_mod.lm_logits(params, hidden[:, -1:], cfg)[:, 0], caches


def decode(
    cfg: ArchConfig, params, token: torch.Tensor, caches: List[KVCache], pos,
    *, backend=None,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """One lockstep decode step at position ``pos`` (an int). token: [B, 1]
    -> (logits [B, V], caches)."""
    b = token.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int64, device=token.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, token, cfg, mode="decode", caches=caches, positions=positions,
        backend=backend,
    )
    return tf_mod.lm_logits(params, hidden, cfg)[:, 0], caches


def prefill_bucketed(
    cfg: ArchConfig, params, tokens: torch.Tensor, lengths: torch.Tensor,
    cache_dtype=torch.bfloat16, *, backend=None,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Prefill a right-padded prompt bucket: tokens [B, Lb], lengths [B].
    Causal attention hides the pad from every real token, so the logits read
    at each row's ``lengths[b] - 1`` are the unpadded prefill logits."""
    b, lb = tokens.shape
    caches = tf_mod.init_caches(cfg, b, lb, cache_dtype, tokens.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, tokens, cfg, mode="prefill", caches=caches, backend=backend
    )
    rows = torch.arange(b, device=tokens.device)
    last = hidden[rows, lengths.to(torch.int64) - 1]
    return tf_mod.lm_logits(params, last[:, None], cfg)[:, 0], caches


def decode_at(
    cfg: ArchConfig, params, token: torch.Tensor, caches: List[KVCache],
    pos: torch.Tensor, *, backend=None,
) -> Tuple[torch.Tensor, List[KVCache]]:
    """Slot-indexed decode step: row ``b`` appends at ``pos[b]`` and attends
    over its own history. ``pos`` [B] is the source of truth for every
    layer's fill point."""
    pos = pos.to(torch.int64)
    caches = [KVCache(c.k, c.v, pos) for c in caches]
    hidden, caches, _ = tf_mod.lm_forward(
        params, token, cfg, mode="decode", caches=caches, positions=pos[:, None],
        backend=backend,
    )
    return tf_mod.lm_logits(params, hidden, cfg)[:, 0], caches


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted from shapes alone (on the meta
    device, nothing is allocated)."""
    params = tf_mod.init_lm_params(cfg, None, torch.device("meta"))
    return sum(x.numel() for x in _leaves(params))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters one token runs through: the routed experts count
    ``top_k`` of ``n_experts``."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    expert_params_per_layer = 3 * cfg.d_model * cfg.moe.d_ff_expert
    n_moe_layers = cfg.n_periods * sum(1 for b in cfg.pattern if b.ffn == "moe")
    routed_total = n_moe_layers * cfg.moe.n_experts * expert_params_per_layer
    routed_active = n_moe_layers * cfg.moe.top_k * expert_params_per_layer
    return total - routed_total + routed_active
