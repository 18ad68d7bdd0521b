"""GEMM entry points of the port: ``matmul`` / ``linear`` / ``grouped_matmul``
over four backends in two numerics families.

The port of the ``matmul``/``linear``/``grouped_matmul`` core of
:mod:`repro.kernels.ops`.

* ``"cuda"`` — the hand-written O-POPE kernels (:func:`.opope_gemm.opope_gemm`,
  and :func:`.opope_grouped.opope_gemm_grouped` for grouped GEMMs), epilogue
  fused into their writeback. ``None``/``"auto"`` resolve to it for tensors
  on the card. Asking for it with CPU tensors raises.
* ``"torch"`` — the plain PyTorch versions (``opope_gemm_plain``,
  ``opope_gemm_grouped_plain``): fp32 product, the same epilogue chain, one
  cast. ``None``/``"auto"`` resolve to it for CPU tensors; on the card it
  runs only when named.
* ``"cuda_q8"`` and ``"torch_q8"`` — family ``"q8"``
  (:mod:`repro_torch.quant.backends`): int8 operands quantized per row of A
  and per column of B, exact int32 products, dequant and epilogue at the
  writeback; ``cuda_q8`` on the hand-written kernels K2 and K5,
  ``torch_q8`` on their plain versions. ``"q8"`` resolves to ``cuda_q8``
  for tensors on the card and to ``torch_q8`` on the CPU.

A backend that cannot take the tensors it is given raises: there are no
fallback chains. Each backend keeps plain integer counts of the GEMMs it
ran: ``calls`` for 2-D ones, ``grouped_calls`` for grouped ones.
:func:`register_backend` adds or replaces a backend, as the reference's
does; ``None``/``"auto"``/``"q8"`` still resolve among the four built-ins.

Epilogues: a backend registered with ``epilogue_fused=True`` (the four
built-ins) takes the chain into its call and runs it at its writeback. A
backend without it, and any chain holding an op with no kernel code (one
registered at run time, :func:`.epilogue.register_epilogue_op`), take the
**post-hoc lane**: the backend's product with ``out_dtype=float32`` and no
epilogue, :func:`.epilogue.apply_epilogue`, one cast. That is the
reference's ``_matmul_impl``/``_grouped_impl`` for its non-fused backends;
on the card the product is still K1 or K4.

Gradients: when an input of :func:`matmul` requires grad, the call runs
through :class:`_Matmul`, an autograd ``Function`` holding the reference's
four ``custom_vjp`` rules (plain product, ``[N]`` bias, full C, epilogue'd
product); :func:`grouped_matmul` runs through :class:`_GroupedMatmul`, the
reference's four grouped rules. Their backward GEMMs run on the backend's
``grad_backend`` through its ``fn`` or ``grouped_fn``, so on the card they
are K1 and K4 launches too, and they count neither into ``calls`` nor into
``gemm.calls`` (the reference's backward calls its backends directly as
well). When no input requires grad, the backend is called as it always
was. A q8-family forward trains the same way: its product runs on the
int8 kernels (K2, K5 on the card), its backward GEMMs and an epilogue'd
product's fp32 accumulator recompute on its full-precision
``grad_backend`` (K1, K4), as the reference's rules put them. A
pre-quantized activation is a serving-only lane (the reference's has no
vjp): under autograd it raises ``NotImplementedError``.

Telemetry (:mod:`repro_torch.obs`, host-side only): every entry-point call
counts into ``gemm.calls`` (labels ``backend``, ``family``, ``shape``
dense/grouped, ``tile`` and ``fusion``) and, under
:class:`repro_torch.obs.attr.capture_gemms`, appends a ``GemmRecord``. The
port has no tuning table, so ``tile`` is always ``"heuristic"`` and
``fusion`` ``"default"`` (every backend runs the epilogue at its
writeback). Inside an engine's quiet step scope (a step key's later
dispatches) the call pays none of this; see :mod:`repro_torch.obs.attr`.
``REPRO_AUDIT=N`` re-executes one in N direct q8-family calls on the
backend's ``grad_backend`` (:mod:`repro_torch.obs.audit`); calls inside an
engine step, and calls that run under autograd (the reference's traced
calls under ``jax.grad``), are never audited.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch import obs as _obs
from repro_torch.obs import attr as _attr

from . import epilogue as _epi
from .opope_gemm import opope_gemm, opope_gemm_plain
from .opope_grouped import opope_gemm_grouped, opope_gemm_grouped_plain
from repro_torch.quant import backends as _q8
from repro_torch.quant.quantize import QuantizedTensor

__all__ = [
    "Backend",
    "register_backend",
    "registered_backends",
    "backend",
    "resolve_backend",
    "family_of",
    "grad_backend_of",
    "reset_counts",
    "matmul",
    "linear",
    "grouped_matmul",
]


@dataclasses.dataclass
class Backend:
    """One GEMM backend: ``fn(a, b, c, out_dtype=)`` on 2-D operands and
    ``grouped_fn`` (the same signature, None for a backend without one) on
    [G, M, K] @ [G, K, N], each taking ``epilogue=`` and
    ``epilogue_operands=`` too where ``epilogue_fused``; the device type it
    runs on (None for any), its numerics family (``"fp"``/``"q8"``), the
    full-precision backend its gradients will run on (``grad_backend``, for
    quantized members), and its call counts."""

    name: str
    fn: Callable[..., torch.Tensor]
    grouped_fn: Optional[Callable[..., torch.Tensor]]
    device_type: Optional[str]
    family: str = "fp"
    grad_backend: Optional[str] = None
    epilogue_fused: bool = False
    calls: int = 0
    grouped_calls: int = 0


_REGISTRY: Dict[str, Backend] = {
    "cuda": Backend("cuda", opope_gemm, opope_gemm_grouped, "cuda", epilogue_fused=True),
    "torch": Backend("torch", opope_gemm_plain, opope_gemm_grouped_plain, None,
                     epilogue_fused=True),
    "cuda_q8": Backend("cuda_q8", _q8.cuda_q8, _q8.cuda_q8_grouped, "cuda",
                       family="q8", grad_backend="cuda", epilogue_fused=True),
    "torch_q8": Backend("torch_q8", _q8.torch_q8, _q8.torch_q8_grouped, None,
                        family="q8", grad_backend="torch", epilogue_fused=True),
}


def register_backend(
    name: str,
    fn: Callable[..., torch.Tensor],
    *,
    grouped: Optional[Callable[..., torch.Tensor]] = None,
    device_type: Optional[str] = None,
    family: str = "fp",
    grad_backend: Optional[str] = None,
    epilogue_fused: bool = False,
) -> None:
    """Register (or replace) a GEMM backend, as the reference's
    ``register_backend``.

    ``fn(a, b, c, out_dtype=)`` computes ``a @ b (+ c)`` with an fp32
    accumulator and one cast (``c`` None, an ``[N]`` row or a full
    ``[M, N]``); ``grouped`` is its [G, M, K] @ [G, K, N] member (``c`` None,
    ``[G, N]`` or ``[G, M, N]``), without which :func:`grouped_matmul` on
    this backend raises. ``device_type`` is the one device type it takes
    tensors on (None: any). ``family`` names its numerics; ``grad_backend``
    the backend its backward GEMMs run on (itself when None).
    ``epilogue_fused=True`` declares that both take ``epilogue=`` and
    ``epilogue_operands=`` and run the chain at their writeback; every
    other backend gets the post-hoc lane. The reference's ``available``,
    ``fallback`` and ``tile_fn`` have no counterpart: there are no chains,
    and no tuned tiles."""
    if not callable(fn):
        raise TypeError(f"backend fn for {name!r} is not callable")
    if grouped is not None and not callable(grouped):
        raise TypeError(f"grouped member for {name!r} is not callable")
    _REGISTRY[name] = Backend(name, fn, grouped, device_type, family=family,
                              grad_backend=grad_backend, epilogue_fused=epilogue_fused)


def registered_backends() -> List[str]:
    return list(_REGISTRY)


def backend(name: str) -> Backend:
    """The registered backend ``name`` (for its ``calls`` count)."""
    return _REGISTRY[name]


def reset_counts() -> None:
    """Set every backend's call count to zero."""
    for be in _REGISTRY.values():
        be.calls = 0
        be.grouped_calls = 0


def resolve_backend(name: Optional[str], device: torch.device) -> str:
    """Resolve a backend request for tensors on ``device``: ``None``/``"auto"``
    pick ``"cuda"`` on the card and ``"torch"`` on the CPU, ``"q8"`` picks
    ``"cuda_q8"`` or ``"torch_q8"`` the same way (registered backends never
    enter these picks); a named backend that cannot take tensors on
    ``device`` raises (there is no fallback)."""
    device = torch.device(device)
    if name in (None, "auto"):
        return "cuda" if device.type == "cuda" else "torch"
    if name == "q8":
        return "cuda_q8" if device.type == "cuda" else "torch_q8"
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(
            f"unknown matmul backend {name!r}; registered: {registered_backends()}"
        )
    if be.device_type is not None and device.type != be.device_type:
        raise ValueError(
            f"matmul backend {name!r} runs on {be.device_type} tensors, "
            f"got tensors on {device}"
        )
    return name


def family_of(name: str) -> str:
    """Numerics family (``"fp"``, ``"q8"``) of a registered backend."""
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(
            f"unknown matmul backend {name!r}; registered: {registered_backends()}"
        )
    return be.family


def grad_backend_of(name: str) -> str:
    """Backend the backward GEMMs of ``name`` run on (itself by default)."""
    be = _REGISTRY.get(name)
    return be.grad_backend if be is not None and be.grad_backend else name


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _serving_only(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"a pre-quantized activation ({name!r}) is a serving-only lane with no "
        f"backward, as the reference's; call it under torch.no_grad() or on "
        f"inputs that do not require grad"
    )


def _member(be: Backend, grouped: bool) -> Callable[..., torch.Tensor]:
    """The backend's 2-D or grouped function; a backend registered without
    a grouped member raises (there is no fallback)."""
    if not grouped:
        return be.fn
    if be.grouped_fn is None:
        raise ValueError(f"matmul backend {be.name!r} has no grouped member")
    return be.grouped_fn


def _run(be: Backend, a, b, c, out_dtype, steps, ep_ops, grouped: bool = False):
    """``epilogue(a @ b (+ c))`` on ``be``: the chain at the backend's
    writeback where it fuses and every op has a kernel code, else the
    post-hoc lane (an fp32 product, the chain, one cast). ``c`` is None
    whenever ``steps`` is not empty (the entry points fold it in)."""
    fn = _member(be, grouped)
    if not steps:
        return fn(a, b, c, out_dtype=out_dtype)
    if be.epilogue_fused and _epi.fusable(steps):
        return fn(a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ep_ops)
    acc = fn(a, b, c, out_dtype=torch.float32)
    return _epi.apply_epilogue(acc, steps, ep_ops).to(out_dtype)


def _bwd_gemm(fn, x: torch.Tensor, y: torch.Tensor, out_dtype) -> torch.Tensor:
    """One backward GEMM ``x @ y`` on ``fn``. Operands of two dtypes (the
    fp32 cotangent of an epilogue'd product against a bf16 operand) are
    both cast to the wider one, exactly, as the reference's ``jnp.dot``
    promotes them: the kernels take one input dtype. Transposed operands
    are copied contiguous (the kernels take contiguous operands)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return fn(x.to(dt).contiguous(), y.to(dt).contiguous(), None, out_dtype=out_dtype)


def _forward(ctx, grouped, name, out_dtype, steps, a, b, c, ep_ops):
    ctx.name, ctx.steps = name, steps
    ctx.c_meta = None if c is None else (c.dtype, c.shape)
    ctx.save_for_backward(a, b, *ep_ops)
    return _run(_REGISTRY[name], a, b, c, out_dtype, steps, ep_ops, grouped)


def _backward(ctx, g, grouped):
    """The reference's rules for a product of :func:`_forward`; the GEMMs
    on the grad backend's 2-D or grouped member."""
    a, b, *ep_ops = ctx.saved_tensors
    need_a, need_b, need_c = ctx.needs_input_grad[3:6]
    need_ops = ctx.needs_input_grad[6:]
    fn = _member(_REGISTRY[grad_backend_of(ctx.name)], grouped)
    g = g.contiguous()
    d_ops = [None] * len(ep_ops)
    if ctx.steps:
        acc = fn(a, b, None, out_dtype=torch.float32)
        g, d = _epi.epilogue_vjp(ctx.steps, tuple(ep_ops), acc, g)
        d_ops = [x.to(o.dtype).reshape(o.shape) if need else None
                 for x, o, need in zip(d, ep_ops, need_ops)]
    da = _bwd_gemm(fn, g, b.transpose(-1, -2), a.dtype) if need_a else None
    db = _bwd_gemm(fn, a.transpose(-1, -2), g, b.dtype) if need_b else None
    dc = None
    if need_c:
        c_dtype, c_shape = ctx.c_meta
        # A bias row ([N], or [G, N] for a grouped product) enters every
        # accumulator row once; a full C enters linearly.
        bias = len(c_shape) == a.ndim - 1
        dc = (g.float().sum(-2) if bias else g).to(c_dtype).reshape(c_shape)
    return (None, None, None, da, db, dc, *d_ops)


class _Matmul(torch.autograd.Function):
    """``epilogue(a @ b (+ c))`` on one backend, differentiable, with the
    reference's rules (``_matmul_nc_bwd``, ``_matmul_bias_bwd``,
    ``_matmul_bwd`` and ``_matmul_ep_bwd`` of :mod:`repro.kernels.ops`):

    * ``dA = g @ B^T`` and ``dB = A^T @ g``, cast to A's and B's dtypes;
    * an ``[N]`` bias: ``dbias = g.sum(0)``; a full C: ``dC = g``;
    * with an epilogue (C is then its first step): the fp32 accumulator is
      recomputed (one more GEMM), :func:`.epilogue.epilogue_vjp` gives its
      fp32 cotangent ``g_acc`` and each operand's, and the two GEMMs above
      run on ``g_acc``.

    Every GEMM of the backward runs on the ``grad_backend`` of the forward's
    backend. A and B^T are made contiguous for it (the kernels take
    contiguous operands)."""

    @staticmethod
    def forward(ctx, name, out_dtype, steps, a, b, c, *ep_ops):
        return _forward(ctx, False, name, out_dtype, steps, a, b, c, ep_ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g, False)


class _GroupedMatmul(torch.autograd.Function):
    """``O[g] = epilogue(A[g] @ B[g] (+ C[g]))``, differentiable, with the
    reference's grouped rules (``_grouped_nc``, ``_grouped_bias``,
    ``_grouped_c`` and ``_grouped_ep`` of :mod:`repro.kernels.ops`):
    ``dA[g] = dO[g] @ B[g]^T`` and ``dB[g] = A[g]^T @ dO[g]``, a ``[G, N]``
    bias gets ``g.sum(1)``, a full C gets ``g``, and an epilogue'd product
    recomputes its fp32 accumulator as one more grouped GEMM and runs the
    two GEMMs on ``g_acc``. Every backward GEMM runs on the grad backend's
    ``grouped_fn`` (on the card: K4, on ``[G, N, K]`` and ``[G, K, M]``
    copies of the transposed operands)."""

    @staticmethod
    def forward(ctx, name, out_dtype, steps, a, b, c, *ep_ops):
        return _forward(ctx, True, name, out_dtype, steps, a, b, c, ep_ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g, True)


def _note_gemm_call(
    shape_family: str, backend: str, m: int, k: int, n: int, groups: int,
    dtype, b_dtype, out_dtype,
) -> None:
    """Count one GEMM entry-point call into ``gemm.calls`` and, while a
    capture is active, record it for utilization attribution. Host-side
    only; a no-op with telemetry off or inside a quiet step scope."""
    if not _obs.enabled() or _attr.step_quiet():
        return
    family = _REGISTRY[backend].family
    _obs.counter(
        "gemm.calls", backend=backend, family=family, shape=shape_family,
        tile="heuristic", fusion="default",
    ).inc()
    if _attr.capturing():
        _attr.record_call(_attr.GemmRecord(
            shape_family=shape_family, backend=backend, family=family,
            m=int(m), k=int(k), n=int(n), g=int(groups),
            a_dtype=_dtype_name(dtype), b_dtype=_dtype_name(b_dtype),
            out_dtype=_dtype_name(out_dtype), tile_source="heuristic",
            tile_key=(backend, shape_family, int(m), int(k), int(n), int(groups),
                      1 if family == "q8" else dtype.itemsize),
        ))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _maybe_audit_gemm(kind, backend, out, ref_fn, m, k, n, g=0) -> None:
    """Shadow-audit hook for quantized-family entry-point calls: cheap
    rejections first (telemetry off, fp family, inside an engine step), the
    sampling gate in :mod:`repro_torch.obs.audit`."""
    if not _obs.enabled() or _attr.in_step():
        return
    family = _REGISTRY[backend].family
    if family == "fp":
        return
    _obs.audit.maybe_audit_gemm(
        kind=kind, backend=backend, family=family, out=out, ref_fn=ref_fn,
        m=int(m), k=int(k), n=int(n), g=int(g),
    )


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """``a @ b (+ c)`` with O-POPE semantics; a: [..., K], b: [K, N].

    Leading dims of ``a`` flatten into M. ``c`` is a full operand matching
    ``a``'s leading dims x N, or an ``[N]`` bias row preloaded into the
    accumulator. ``epilogue`` is a pipeline of registered post-ops
    (:mod:`.epilogue`) run on the fp32 accumulator before the single cast;
    a ``c`` passed with an epilogue is folded in as its first step (``bias``
    for a row, ``residual`` for a full operand). ``out_dtype`` defaults to
    ``a.dtype``.

    ``a`` may also be a pre-quantized activation (anything with ``.q`` /
    ``.scale``, e.g. a ``QuantizedTensor``, the output of an upstream
    ``requant_int8`` epilogue) on a q8-family backend, which then consumes
    its int8 values as they are; ``out_dtype`` then defaults to fp32.
    """
    pre_q = hasattr(a, "q") and hasattr(a, "scale")
    arr = a.q if pre_q else a
    out_dtype = out_dtype or (torch.float32 if pre_q else arr.dtype)
    name = resolve_backend(backend, arr.device)
    batch_shape = tuple(arr.shape[:-1])
    m = math.prod(batch_shape)
    n = b.shape[-1]
    _note_gemm_call("dense", name, m, arr.shape[-1], n, 0, arr.dtype, b.dtype, out_dtype)
    steps, raw_ops = _epi.normalize_epilogue(epilogue)
    if steps and c is not None:
        # C enters the accumulator linearly: preload-then-epilogue equals
        # bias/residual-step-then-rest.
        if c.ndim == 1:
            steps, raw_ops = ("bias",) + steps, (c,) + raw_ops
        else:
            steps, raw_ops = ("residual",) + steps, (c,) + raw_ops
        c = None
    ep_ops = tuple(
        x.contiguous()
        for x in _epi.canonicalize_operands(steps, raw_ops, n=n, m=m, device=arr.device)
    )
    if c is not None:
        c = (c if c.ndim == 1 else c.reshape(m, n)).contiguous()
    be = _REGISTRY[name]
    a2 = arr.reshape(m, arr.shape[-1]).contiguous()
    if pre_q:
        if be.family != "q8":
            raise ValueError(
                f"pre-quantized activations need a q8-family backend; "
                f"{name!r} is family {be.family!r}"
            )
        scale = torch.as_tensor(a.scale, dtype=torch.float32, device=arr.device)
        a2 = QuantizedTensor(
            a2, scale.reshape(m, 1) if scale.numel() == m else scale.reshape(1, 1))
    be.calls += 1
    b2 = b.contiguous()
    if _needs_grad(a2, getattr(a, "scale", None), b2, c, *ep_ops):
        if pre_q:
            raise _serving_only(name)
        # Not audited: the reference never audits a call under jax.grad.
        out = _Matmul.apply(name, out_dtype, steps, a2, b2, c, *ep_ops)
    else:
        out = _run(be, a2, b2, c, out_dtype, steps, ep_ops)
        if not pre_q:  # a pre-quantized A has no fp twin to audit against
            _maybe_audit_gemm(
                "dense", name, out,
                lambda: _run(_REGISTRY[grad_backend_of(name)], a2, b2, c, out_dtype, steps,
                             ep_ops),
                m, a2.shape[1], n)
    return out if len(batch_shape) == 1 else out.reshape(*batch_shape, n)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """Linear layer on the O-POPE path: the [N] bias rides the C preload."""
    return matmul(x, w, bias, backend=backend, out_dtype=out_dtype, epilogue=epilogue)


def grouped_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    backend: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    epilogue=None,
) -> torch.Tensor:
    """``O[g] = A[g] @ B[g] (+ C[g])``; a: [G, M, K], b: [G, K, N].

    One launch for a whole family of same-shape GEMMs (the MoE experts).
    ``c`` is ``None``, a full ``[G, M, N]`` preload, or a ``[G, N]``
    per-group bias row broadcast at the accumulator preload. ``epilogue``
    post-ops apply per group to the fp32 accumulator before the single cast;
    their operands are a scalar, an ``[N]`` or ``[G, N]`` row, or a full
    ``[G, M, N]``. A ``c`` passed with an epilogue is folded in as its first
    step (``bias`` for a row, ``residual`` for a full operand). Backends
    resolve as in :func:`matmul`; a q8-family backend quantizes per group
    (A per (group, row), B per (group, column)). Under autograd the call
    runs through :class:`_GroupedMatmul`, whose backward runs on the
    backend's ``grad_backend``, and is not audited.
    """
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(
            f"grouped_matmul wants a [G, M, K] @ [G, K, N]; got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    out_dtype = out_dtype or a.dtype
    name = resolve_backend(backend, a.device)
    g, m, n = a.shape[0], a.shape[1], b.shape[2]
    _note_gemm_call("grouped", name, m, a.shape[2], n, g, a.dtype, b.dtype, out_dtype)
    steps, raw_ops = _epi.normalize_epilogue(epilogue)
    if steps and c is not None:
        name_c = "bias" if c.ndim == 2 else "residual"
        steps, raw_ops = (name_c,) + steps, (c,) + raw_ops
        c = None
    ep_ops = tuple(
        x.contiguous()
        for x in _epi.canonicalize_operands(
            steps, raw_ops, n=n, m=m, groups=g, device=a.device)
    )
    be = _REGISTRY[name]
    be.grouped_calls += 1
    a2, b2, c2 = a.contiguous(), b.contiguous(), None if c is None else c.contiguous()
    if _needs_grad(a2, b2, c2, *ep_ops):
        return _GroupedMatmul.apply(name, out_dtype, steps, a2, b2, c2, *ep_ops)
    out = _run(be, a2, b2, c2, out_dtype, steps, ep_ops, grouped=True)
    _maybe_audit_gemm(
        "grouped", name, out,
        lambda: _run(_REGISTRY[grad_backend_of(name)], a2, b2, c2, out_dtype, steps, ep_ops,
                     grouped=True),
        m, a.shape[2], n, g=g)
    return out
