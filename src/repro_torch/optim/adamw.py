"""AdamW with a cosine schedule and global-norm clipping.

The port of :mod:`repro.optim.adamw`, in plain PyTorch under ``no_grad``
(an optimizer update reads and writes each parameter and moment once: it is
bound by device memory, and the reference leaves it to XLA). The arithmetic
is the reference's: fp32 math whatever the parameter and moment dtypes,
bias corrections ``1 - b**step`` in fp32, decay on matrices only
(``ndim >= 2``), moments stored in ``moment_dtype``.

:func:`apply_updates` writes the new parameters and moments into the
tensors it is given and returns them: the reference's jitted train step
donates both, and a second copy of 1.35 G parameters' fp32 moments would
cost 10.8 GB of device memory. For the same reason it updates each leaf
(the clip scale included) in flat slices of at most :data:`UPDATE_SLICE`
elements: the arithmetic is elementwise, so the result is the same bits,
and its fp32 temporaries stay a slice's size (one of grok-1's
``[8, 6144, 32768]`` expert leaves would take 6.4 GB each).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, map_leaves

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates", "cosine_lr"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
UPDATE_SLICE = 1 << 26  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    mu: Any  # first moments (tree like params)
    nu: Any  # second moments


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = next(leaves(params)).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=map_leaves(zeros, params),
        nu=map_leaves(zeros, params),
    )


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_frac * peak_lr`` at ``total_steps``; fp32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(g.to(torch.float32) ** 2) for g in leaves(tree)])))


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: OptState, cfg: AdamWConfig
) -> Tuple[Any, OptState, dict]:
    """One AdamW step, in place: returns ``params`` and the state's moment
    tensors updated, a new step count and ``{"lr", "grad_norm"}``."""
    gnorm = _global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd_slice(p, g, m, v, decay):
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        mhat = m32 / b1c
        vhat = v32 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    def upd(p, g, m, v):
        decay = p.ndim >= 2
        if not all(x.is_contiguous() for x in (p, g, m, v)):
            return upd_slice(p, g, m, v, decay)
        flat = [x.view(-1) for x in (p, g, m, v)]
        for i in range(0, p.numel(), UPDATE_SLICE):
            upd_slice(*(x[i:i + UPDATE_SLICE] for x in flat), decay)

    map_leaves(upd, params, grads, state.mu, state.nu)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {"lr": lr, "grad_norm": gnorm}
