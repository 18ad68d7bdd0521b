"""Training loop: the train step (loss, gradients, AdamW) and the loop
around it with its straggler watchdog and step telemetry.

The port of :mod:`repro.train.loop` for the dense and MoE decoders. The
step runs eagerly: the reference's ``jit=`` and ``donate=`` have no
counterpart here (:func:`repro_torch.optim.apply_updates` updates in place,
which is what donation buys the reference). Gradients come from autograd
through :class:`repro_torch.kernels.ops._Matmul` and ``_GroupedMatmul``, so
on the card every GEMM of the forward and the backward is a K1 launch, and
every expert GEMM a K4 launch.

Not ported yet, and refused with ``NotImplementedError`` (ROADMAP A.6b):
checkpoints and resume (``ckpt_dir``) and training under a q8-family
``policy``.

Telemetry: each step observes ``train.step_seconds``, sets
``train.tokens_per_sec`` and emits a ``train_step`` event with the
reference's fields; ``roofline_frac`` divides the step's 6·N·D model FLOP
rate by :func:`repro_torch.core.roofline.spec_for_device`'s peak (the H100's
989 TFLOP/s) where the reference divides by its TPU's. A slow step counts
into ``train.stragglers`` and emits a ``straggler`` event.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import roofline as _roofline
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates, init_opt_state
from repro_torch.quant.policy import ROLES
from repro_torch.tree import leaves, map_leaves

__all__ = ["TrainLoopConfig", "make_train_step", "train", "TrainResult"]

_A6B = "ROADMAP A.6b"


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None  # checkpoints are not ported: set, it raises
    log_every: int = 10
    watchdog_factor: float = 3.0
    fail_at_step: Optional[int] = None  # fault-injection hook (tests)


@dataclasses.dataclass
class TrainResult:
    losses: list
    resumed_from: Optional[int]
    straggler_steps: int
    final_step: int


def _check_trainable(policy) -> None:
    """Refuse what has no backward in the port yet: a policy that puts any
    role on a q8-family backend."""
    names = ({policy.backend_for(r) for r in ROLES} if hasattr(policy, "backend_for")
             else {policy})
    for name in names - {None, "auto"}:
        if name == "q8" or ops.family_of(name) != "fp":
            raise NotImplementedError(
                f"training under a q8-family policy ({name!r}) is not ported ({_A6B})")


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, policy=None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, eager.

    With ``cfg.grad_accum > 1`` the batch's leading dim is split into that
    many microbatches, run one after another, their gradients summed in
    fp32 and divided by the count, as are their losses. ``policy`` is a
    backend name (or an fp-family precision policy) for the forward GEMMs;
    the backward runs on each backend's ``grad_backend``. Parameters and
    moments are updated in place, the block leaves seen by AdamW as the
    reference's stacks (:func:`_stacked`)."""
    _check_trainable(policy)

    def value_and_grad(params, batch):
        # Leaves that require grad, sharing storage with the caller's.
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = model_api.loss_fn(cfg, live, batch, backend=policy)
        grads = torch.autograd.grad(loss, list(leaves(live)))
        it = iter(grads)
        return loss.detach(), map_leaves(lambda _p: next(it), params)

    def step(params, opt_state, batch):
        n_micro = cfg.grad_accum
        if n_micro <= 1:
            loss, grads = value_and_grad(params, batch)
        else:
            grads = map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=next(leaves(params)).device)
            for micro in zip(*(torch.chunk(v, n_micro) for v in batch.values())):
                li, gi = value_and_grad(params, dict(zip(batch, micro)))
                map_leaves(lambda a, b: a.add_(b.to(torch.float32)), grads, gi)
                loss = loss + li
            loss = loss / n_micro
            grads = map_leaves(lambda g: g / n_micro, grads)
        _, new_state, metrics = apply_updates(
            _stacked(params), _stacked(grads),
            OptState(opt_state.step, _stacked(opt_state.mu), _stacked(opt_state.nu)), opt_cfg)
        metrics["loss"] = loss
        return params, OptState(new_state.step, opt_state.mu, opt_state.nu), metrics

    return step


def _stacked(tree):
    """``tree`` with every block leaf as a ``[1, ...]`` view. The reference
    stacks each block's leaves over periods (its layers are one
    ``lax.scan``), so AdamW's decay rule (``ndim >= 2``) decays every block
    leaf, the norm scales included; given these views (one layer a period,
    the stacks of a dense decoder), the same rule picks the same leaves.
    The update writes through the views into the port's tensors."""
    return {**tree, "blocks": [map_leaves(lambda x: x.unsqueeze(0), b) for b in tree["blocks"]]}


class _Watchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.times: list = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = (
            len(self.times) >= 5
            and dt > self.factor * statistics.median(self.times)
        )
        self.times.append(dt)
        if len(self.times) > 50:
            self.times.pop(0)
        if slow:
            self.flagged += 1
        return slow


def train(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig,
    loop: TrainLoopConfig,
    batch_fn: Callable[[int], Dict[str, torch.Tensor]],
    *,
    generator: Optional[torch.Generator] = None,
    params: Any = None,
    device=None,
    log: Callable[[str], None] = print,
    policy=None,
) -> TrainResult:
    """Run training from step 0. ``batch_fn(step)`` must be deterministic and
    give tensors on the parameters' device. Parameters are ``params`` or
    :func:`repro_torch.models.api.init_params` on ``device`` (default
    ``cuda``) from ``generator`` (seed 0 when omitted)."""
    if loop.ckpt_dir:
        raise NotImplementedError(f"checkpoints and resume are not ported ({_A6B})")
    if params is None:
        params = model_api.init_params(cfg, generator, device)
    device = next(leaves(params)).device
    opt_cfg = dataclasses.replace(opt_cfg, moment_dtype=cfg.moment_dtype)
    opt_state = init_opt_state(params, opt_cfg)

    step_fn = make_train_step(cfg, opt_cfg, policy=policy)
    wd = _Watchdog(loop.watchdog_factor)
    losses = []
    # The 6*N*D train-FLOP estimate's N, so each step event carries its
    # achieved GFLOP/s and its fraction of the card's peak.
    n_params = sum(int(x.numel()) for x in leaves(params))
    for step in range(loop.total_steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the device
        losses.append(loss)
        dt = time.perf_counter() - t0
        if _obs.enabled():
            tok_arr = batch.get("tokens", next(iter(batch.values())))
            tokens = int(tok_arr.numel())
            flops = _roofline.model_flops(n_params, tokens, kind="train")
            tok_s = tokens / dt if dt else 0.0
            gflops = flops / dt / 1e9 if dt else 0.0
            _obs.histogram("train.step_seconds").observe(dt)
            _obs.gauge("train.tokens_per_sec").set(tok_s)
            _obs.event(
                "train_step",
                step=step,
                loss=loss,
                wall_s=dt,
                tokens=tokens,
                tokens_per_sec=tok_s,
                gflops_per_sec=gflops,
                roofline_frac=flops / dt / _roofline.spec_for_device(device).peak_flops
                if dt else 0.0,
            )
        if wd.observe(dt):
            log(f"[train] straggler: step {step} took {dt:.3f}s")
            _obs.counter("train.stragglers").inc()
            _obs.event("straggler", step=step, wall_s=dt)
        if loop.log_every and step % loop.log_every == 0:
            log(
                f"[train] step {step} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                f"{dt*1e3:.0f}ms"
            )
    return TrainResult(
        losses=losses,
        resumed_from=None,
        straggler_steps=wd.flagged,
        final_step=loop.total_steps,
    )
