"""Training loop: the train step (loss, gradients, AdamW) and the loop
around it with checkpoints, resume, its straggler watchdog and step
telemetry.

The port of :mod:`repro.train.loop` for the dense and MoE decoders. The
step runs eagerly: the reference's ``jit=`` and ``donate=`` have no
counterpart here (:func:`repro_torch.optim.apply_updates` updates in place,
which is what donation buys the reference). Gradients come from autograd
through :class:`repro_torch.kernels.ops._Matmul` and ``_GroupedMatmul``, so
on the card every GEMM of the forward and the backward is a K1 launch, and
every expert GEMM a K4 launch. Under a q8-family ``policy`` the quantized
roles' forward GEMMs (and their remat recompute) are K2 and K5 launches,
their backward GEMMs K1 and K4 on the full-precision ``grad_backend``.

With ``ckpt_dir`` the loop resumes from the newest complete checkpoint
(:mod:`repro_torch.checkpoint`, the reference's file format), restored in
place into the parameters and moments, and saves every ``ckpt_every``
steps and at the end through the async writer; a failure flushes the
writer without masking the failure.

Refused with ``NotImplementedError``: a policy whose ``requant`` names a
role on a q8-family backend. That lane feeds the next GEMM an int8
activation, which carries no gradient: the reference's gradients through
it are exactly zero for the role's weights and the norm before them, and
the port does not reproduce a silent zero gradient.

Telemetry: each step observes ``train.step_seconds``, sets
``train.tokens_per_sec`` and emits a ``train_step`` event with the
reference's fields; ``roofline_frac`` divides the step's 6·N·D model FLOP
rate by :func:`repro_torch.core.roofline.spec_for_device`'s peak (the H100's
989 TFLOP/s) where the reference divides by its TPU's. A slow step counts
into ``train.stragglers`` and emits a ``straggler`` event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import obs as _obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import roofline as _roofline
from repro_torch.kernels import ops
from repro_torch.models import api as model_api
from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates, init_opt_state
from repro_torch.tree import leaves, map_leaves

__all__ = ["TrainLoopConfig", "make_train_step", "train", "TrainResult"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    watchdog_factor: float = 3.0
    fail_at_step: Optional[int] = None  # fault-injection hook (tests)


@dataclasses.dataclass
class TrainResult:
    losses: list
    resumed_from: Optional[int]
    straggler_steps: int
    final_step: int
    # The final state (the reference's jitted loop keeps it to itself): the
    # caller's parameter tensors, updated in place, and the moments.
    params: Any = None
    opt_state: Optional[OptState] = None


def _check_trainable(policy) -> None:
    """Refuse a policy whose ``requant`` names a role on a q8-family
    backend: its int8 hidden activation stops the gradient."""
    for role in getattr(policy, "requant", None) or {}:
        name = policy.backend_for(role)
        if name == "q8" or (name not in (None, "auto") and ops.family_of(name) != "fp"):
            raise NotImplementedError(
                f"policy {getattr(policy, 'name', policy)!r} requantizes role {role!r} on "
                f"the q8-family backend {name!r}: that int8 activation carries no gradient "
                f"(the reference's gradients of the role's weights are exactly zero there); "
                f"train without requant")


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, policy=None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, eager.

    With ``cfg.grad_accum > 1`` the batch's leading dim is split into that
    many microbatches, run one after another, their gradients summed in
    fp32 and divided by the count, as are their losses. ``policy`` is a
    backend name or a precision policy for the forward GEMMs, of either
    family (a requant policy on a q8-family role raises); the backward runs
    on each backend's ``grad_backend``. Parameters and
    moments are updated in place, the block leaves seen by AdamW as the
    reference's stacks (:func:`_stacked`)."""
    _check_trainable(policy)

    def value_and_grad(params, batch):
        # Leaves that require grad, sharing storage with the caller's.
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = model_api.loss_fn(cfg, live, batch, backend=policy)
        # A leaf the loss does not read (a parallel block's norm_ffn) gets
        # a zero gradient, as jax.grad gives it.
        grads = torch.autograd.grad(loss, list(leaves(live)), allow_unused=True,
                                    materialize_grads=True)
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
                # add_ widens b exactly inside the add: no fp32 copy of it.
                map_leaves(lambda a, b: a.add_(b), grads, gi)
                loss = loss + li
            loss = loss / n_micro
            map_leaves(lambda g: g.div_(n_micro), grads)  # in place: no second fp32 copy
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


def _allocator_settings() -> str:
    get = getattr(torch._C, "_accelerator_getAllocatorSettings", None)
    if get is not None:
        return get()
    return os.environ.get("PYTORCH_ALLOC_CONF") or os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")


def _set_allocator(settings: str) -> None:
    # The accelerator-wide setter replaces the CUDA one in newer PyTorch.
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(settings)


@contextlib.contextmanager
def expandable_segments(device):
    """Inside the block the CUDA caching allocator grows its segments in
    place (``expandable_segments``), so the pages of freed blocks serve a
    later, larger request; the setting found on entry is restored on exit.
    Without it a large model's step can fail on a fragmented pool with
    memory reserved but unused: grok-1-314b's one-layer step peaks within a
    few GB of the H100's memory, and a fragmented pool refused it a 6 GiB
    fp32 weight copy. Nothing changes off CUDA, or where the process runs
    with the setting already (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``)."""
    found = dict(kv.split(":", 1) for kv in _allocator_settings().split(",") if ":" in kv)
    if torch.device(device).type != "cuda" or found.get("expandable_segments") == "True":
        yield
        return
    torch.cuda.empty_cache()
    _set_allocator("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        _set_allocator("expandable_segments:" + found.get("expandable_segments", "False"))


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
    """Run (or resume) training. ``batch_fn(step)`` must be deterministic
    and give tensors on the parameters' device. Parameters are ``params``
    (updated in place) or :func:`repro_torch.models.api.init_params` on
    ``device`` (default ``cuda``) from ``generator`` (seed 0 when omitted).
    With ``loop.ckpt_dir`` a complete checkpoint there is restored into
    them and training resumes at its step; the final state comes back in
    the result. On the card it runs under :func:`expandable_segments`."""
    device = model_api.resolve_device(device) if params is None else next(leaves(params)).device
    with expandable_segments(device):
        return _train(cfg, opt_cfg, loop, batch_fn, generator, params, device, log, policy)


def _train(cfg, opt_cfg, loop, batch_fn, generator, params, device, log, policy) -> TrainResult:
    if params is None:
        params = model_api.init_params(cfg, generator, device)
    opt_cfg = dataclasses.replace(opt_cfg, moment_dtype=cfg.moment_dtype)
    opt_state = init_opt_state(params, opt_cfg)

    start = 0
    resumed_from = saved = None
    writer = None
    if loop.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(loop.ckpt_dir, period=len(cfg.pattern))
        last = ckpt.latest_step(loop.ckpt_dir)
        if last is not None:
            live = {"params": params, "opt": opt_state}
            _copy_into(live, ckpt.restore(loop.ckpt_dir, last, like=live, device="cpu",
                                             period=len(cfg.pattern)))
            start = resumed_from = saved = last
            log(f"[train] resumed from step {last}")

    step_fn = make_train_step(cfg, opt_cfg, policy=policy)
    wd = _Watchdog(loop.watchdog_factor)
    losses = []
    # The 6*N*D train-FLOP estimate's N, so each step event carries its
    # achieved GFLOP/s and its fraction of the card's peak.
    n_params = sum(int(x.numel()) for x in leaves(params))
    try:
        for step in range(start, loop.total_steps):
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
            if writer and (step + 1) % loop.ckpt_every == 0:
                writer.save(step + 1, {"params": params, "opt": opt_state})
                saved = step + 1
        # The reference saves at the end even where the last interval just
        # did; the same state is not written twice here.
        if writer and saved != loop.total_steps:
            writer.save(loop.total_steps, {"params": params, "opt": opt_state})
        if writer:
            writer.wait()
    finally:
        # A failing step must not also lose the checkpoint already in
        # flight: join the writer, so every save issued before the failure
        # is committed.
        if writer:
            try:
                writer.wait()
            except Exception as flush_err:  # don't mask the original failure
                log(f"[train] checkpoint flush failed: {flush_err}")
    return TrainResult(
        losses=losses,
        resumed_from=resumed_from,
        straggler_steps=wd.flagged,
        final_step=loop.total_steps,
        params=params,
        opt_state=opt_state,
    )


def _copy_into(live: Any, restored: Any) -> None:
    """Write a restored tree into the live tensors of the same structure,
    so the device holds one copy of the state; a dtype the live tensor does
    not have (another configuration's checkpoint) raises."""
    pairs = list(zip(leaves(live), leaves(restored)))
    for dst, src in pairs:
        if dst.dtype != src.dtype:
            raise ValueError(f"checkpoint leaf of dtype {src.dtype} for a {dst.dtype} tensor")
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
