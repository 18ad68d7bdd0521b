"""Fused GEMM epilogues: the post-ops that ride the accumulator writeback.

The port of :mod:`repro.kernels.epilogue`. O-POPE's output-stationary GEMM
touches the [M, N] result once, at writeback; every activation, residual add
or re-quantize applied there runs on the fp32 accumulator before the single
final cast, instead of re-reading the result from device memory afterwards.

A spec is a pipeline of named ops, each bare (``"silu"``) or carrying one
operand (``("residual", x)``). Operand kinds:

========  ===========================  ============================
kind      operand shape                broadcast against [M, N] as
========  ===========================  ============================
none      —                            —
scalar    one element                  (1, 1)
row       ``[N]``                      (1, N)
full      ``[..., N]`` matching out    (M, N)
========  ===========================  ============================

Each op has an fp32 ``apply`` (the plain PyTorch version, used on the CPU
and as the reference on the card), optionally its own ``vjp``, and, for the
nine built-ins, a fixed integer code that the CUDA kernels
(``csrc/opope_tile.cuh``) switch on. The names, kinds and fp32 arithmetic
match the JAX registry op for op. :func:`register_epilogue_op` adds or
replaces an op at run time; such an op has no kernel code, so a chain that
holds it never reaches a kernel's epilogue: :mod:`.ops` runs it post-hoc
(an fp32 product, :func:`apply_epilogue`, one cast), as the reference runs
every chain on a backend that does not fuse. :func:`epilogue_vjp` composes
the chain's backward for the autograd rules in :mod:`.ops`; an op without
its own ``vjp`` differentiates through autograd of its ``apply``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "EpilogueOp",
    "register_epilogue_op",
    "fusable",
    "ACTIVATIONS",
    "OP_CODES",
    "KIND_CODES",
    "epilogue_ops",
    "op_def",
    "op_kind",
    "normalize_epilogue",
    "canonicalize_operands",
    "apply_epilogue",
    "epilogue_vjp",
    "cast_out",
]

ApplyFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
# vjp(acc_in, operand, g) -> (d_acc, d_operand or None): the cotangents of
# one op at its *input* accumulator (the replayed forward chain supplies it).
VjpFn = Callable[
    [torch.Tensor, Optional[torch.Tensor], torch.Tensor],
    Tuple[torch.Tensor, Optional[torch.Tensor]],
]

KIND_CODES: Dict[str, int] = {"none": 0, "scalar": 1, "row": 2, "full": 3}

# Past these magnitudes an 8-bit float rounds to no finite value: e4m3 (no
# infinity) gives NaN and e5m2 infinity. Each is the tie between the largest
# finite value (448, 57344) and the next step up, which round-to-nearest-even
# sends down.
_E4M3_NAN_ABOVE = 464.0


def cast_out(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The single final cast of every plain version (K1, K3, K4 and the
    post-hoc lane), by the reference's rule (ml_dtypes' ``astype``): round to
    nearest even; fp16, bf16 and e5m2 overflow to infinity; e4m3 past 448
    (its tie with the next step, 464, rounds down) gives NaN, where torch's
    own cast saturates to 448. The kernels' writeback
    (``csrc/opope_tile.cuh::store_out``) follows the same rule bit for bit."""
    y = x.to(dtype)
    if dtype == torch.float8_e4m3fn:
        y = torch.where(x.abs() > _E4M3_NAN_ABOVE, torch.full_like(y, float("nan")), y)
    return y


@dataclasses.dataclass(frozen=True)
class EpilogueOp:
    """One registered post-op: name, operand kind, fp32 apply, kernel code
    (None for an op registered at run time), optional vjp."""

    name: str
    kind: str
    apply: ApplyFn
    code: Optional[int]
    vjp: Optional[VjpFn] = None


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation: jax.nn.gelu's default (approximate=True)
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": _gelu,
    "silu": torch.nn.functional.silu,
    "swish": torch.nn.functional.silu,  # alias: same op, HF-style naming
    "relu": torch.relu,
}


def _requant_int8(acc: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # Snap onto the int8 grid of a scalar scale: x / s (a true division, not
    # a reciprocal multiply), round half to even, clip to [-127, 127].
    return torch.clamp(torch.round(acc / s), -127.0, 127.0)


def _requant_int8_vjp(
    acc: torch.Tensor, s: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    # Straight-through: the grid is invisible to the gradient, out ~ acc / s
    # where unclipped and 0 where clipped. d/dacc = 1/s, d/ds = -acc/s^2,
    # both masked to the pass-through region.
    x = acc / s
    gm = g * (torch.abs(x) <= 127.0)
    return gm / s, torch.sum(gm * (-x / s)).reshape(s.shape)


_REGISTRY: Dict[str, EpilogueOp] = {}


def _builtin(name: str, kind: str, apply: ApplyFn, vjp: Optional[VjpFn] = None) -> None:
    _REGISTRY[name] = EpilogueOp(name, kind, apply, code=len(_REGISTRY), vjp=vjp)


for _name, _fn in ACTIVATIONS.items():
    _builtin(_name, "none", lambda acc, _o, _f=_fn: _f(acc))
_builtin("bias", "row", lambda acc, o: acc + o)
_builtin("residual", "full", lambda acc, o: acc + o)
_builtin("mul", "full", lambda acc, o: acc * o)
_builtin("scale", "row", lambda acc, o: acc * o)
_builtin("requant_int8", "scalar", _requant_int8, vjp=_requant_int8_vjp)

# gelu 0, silu 1, swish 2, relu 3, bias 4, residual 5, mul 6, scale 7,
# requant_int8 8 — the enum in csrc/opope_tile.cuh. Fixed here: ops
# registered later never enter it.
OP_CODES: Dict[str, int] = {name: op.code for name, op in _REGISTRY.items()}


def register_epilogue_op(
    name: str, kind: str, apply: ApplyFn, *, vjp: Optional[VjpFn] = None
) -> None:
    """Register (or replace) an epilogue op, as the reference's
    ``register_epilogue_op``.

    ``apply(acc_f32, operand)`` takes the fp32 accumulator and the operand
    broadcast-ready against it (module docstring) and must keep fp32: the
    single final cast belongs to the GEMM. ``vjp(acc_in, operand, g) ->
    (d_acc, d_operand)`` overrides autograd of ``apply``. The op gets no
    kernel code, and neither does a built-in it replaces: every chain that
    holds it runs post-hoc (:func:`fusable` is false for it)."""
    if kind not in KIND_CODES:
        raise ValueError(f"bad epilogue operand kind {kind!r}; one of {tuple(KIND_CODES)}")
    if not callable(apply):
        raise TypeError(f"epilogue apply for {name!r} is not callable")
    _REGISTRY[name] = EpilogueOp(name, kind, apply, code=None, vjp=vjp)


def fusable(steps: Sequence[str]) -> bool:
    """Whether every op of a chain has a kernel code, so a fusing backend
    can run it at its writeback."""
    return all(op_def(name).code is not None for name in steps)


def epilogue_ops() -> List[str]:
    """Names of every registered epilogue op."""
    return list(_REGISTRY)


def op_def(name: str) -> EpilogueOp:
    op = _REGISTRY.get(name)
    if op is None:
        raise ValueError(
            f"unknown epilogue op {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return op


def op_kind(name: str) -> str:
    return op_def(name).kind


Step = Union[str, Tuple[str, Any]]
EpilogueSpec = Union[Step, Sequence[Step]]


def normalize_epilogue(
    spec: Optional[EpilogueSpec],
) -> Tuple[Tuple[str, ...], Tuple[Any, ...]]:
    """Normalize a spec to ``(step_names, raw_operands)``.

    ``raw_operands`` holds one entry per operand-taking step, in pipeline
    order. Unknown names and arity mismatches raise: a typo'd activation must
    never silently become identity.
    """
    if spec is None:
        return (), ()
    if isinstance(spec, str):
        steps: Sequence[Step] = [spec]
    elif (
        isinstance(spec, tuple)
        and len(spec) == 2
        and isinstance(spec[0], str)
        # ("silu", ("mul", x)) is a two-step sequence, ("residual", x) one step
        and not isinstance(spec[1], (str, tuple, list))
    ):
        steps = [spec]
    else:
        steps = list(spec)
    names: List[str] = []
    operands: List[Any] = []
    for step in steps:
        if isinstance(step, str):
            name, operand = step, None
        elif isinstance(step, tuple) and len(step) == 2:
            name, operand = step
        else:
            raise ValueError(
                f"bad epilogue step {step!r}: want 'name' or ('name', operand)"
            )
        op = op_def(name)
        if op.kind == "none":
            if operand is not None:
                raise ValueError(f"epilogue op {name!r} takes no operand")
        else:
            if operand is None:
                raise ValueError(
                    f"epilogue op {name!r} ({op.kind}) needs an operand: "
                    f"pass ({name!r}, operand)"
                )
            operands.append(operand)
        names.append(name)
    return tuple(names), tuple(operands)


def canonicalize_operands(
    steps: Tuple[str, ...],
    operands: Tuple[Any, ...],
    *,
    n: int,
    m: int,
    groups: int = 0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, ...]:
    """Reshape raw operands broadcast-ready against the [M, N] (or, with
    ``groups``, the [G, M, N]) accumulator, validating shapes:

    dense:   scalar -> (1, 1) fp32;    row [N] -> (1, N);  full -> (M, N)
    grouped: scalar -> (1, 1, 1) fp32; row [G, N] or [N] -> (G, 1, N);
             full -> (G, M, N)

    Dtypes other than the scalar's are kept."""
    out: List[torch.Tensor] = []
    it = iter(operands)
    for name in steps:
        kind = op_kind(name)
        if kind == "none":
            continue
        x = torch.as_tensor(next(it), device=device)
        if kind == "scalar":
            if x.numel() != 1:
                raise ValueError(
                    f"epilogue op {name!r} wants a scalar operand; got "
                    f"shape {tuple(x.shape)}"
                )
            out.append(x.to(torch.float32).reshape((1, 1, 1) if groups else (1, 1)))
        elif kind == "row":
            if groups:
                if tuple(x.shape) == (n,):
                    x = x.expand(groups, n)
                if tuple(x.shape) != (groups, n):
                    raise ValueError(
                        f"epilogue op {name!r} row operand shape {tuple(x.shape)} "
                        f"!= {(groups, n)} (or broadcastable {(n,)})"
                    )
                out.append(x.reshape(groups, 1, n))
            else:
                if tuple(x.shape) != (n,):
                    raise ValueError(
                        f"epilogue op {name!r} row operand shape {tuple(x.shape)} "
                        f"!= {(n,)}"
                    )
                out.append(x.reshape(1, n))
        else:
            if x.numel() != (groups or 1) * m * n or x.shape[-1] != n:
                raise ValueError(
                    f"epilogue op {name!r} full operand shape {tuple(x.shape)} "
                    f"incompatible with output {(groups, m, n) if groups else (m, n)}"
                )
            out.append(x.reshape((groups, m, n) if groups else (m, n)))
    return tuple(out)


def apply_epilogue(
    acc: torch.Tensor,
    steps: Tuple[str, ...],
    operands: Tuple[torch.Tensor, ...],
) -> torch.Tensor:
    """Run the op pipeline on the fp32 accumulator (no final cast here).
    Operands are widened to fp32 before use."""
    x = acc.to(torch.float32)
    it = iter(operands)
    for name in steps:
        op = op_def(name)
        operand = None if op.kind == "none" else next(it).to(torch.float32)
        x = op.apply(x, operand)
    return x


def epilogue_vjp(
    steps: Tuple[str, ...],
    operands: Tuple[torch.Tensor, ...],
    acc: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Backward through the op pipeline at input accumulator ``acc``.

    Returns ``(d_acc, d_operands)`` in fp32, ``d_operands`` aligned to
    ``operands`` and reduced over their broadcast dimensions. The forward
    chain is replayed op by op (the fused writeback never keeps the
    intermediates); each op uses its registered ``vjp`` or differentiates
    through autograd of its ``apply``.
    """
    ops_f = tuple(o.detach().to(torch.float32) for o in operands)
    inputs: List[torch.Tensor] = []
    per_step: List[Tuple[EpilogueOp, Optional[torch.Tensor]]] = []
    it = iter(ops_f)
    x = acc.detach().to(torch.float32)
    for name in steps:
        op = op_def(name)
        operand = None if op.kind == "none" else next(it)
        inputs.append(x)
        per_step.append((op, operand))
        x = op.apply(x, operand)
    d_ops: List[Optional[torch.Tensor]] = [None] * len(per_step)
    gx = g.to(torch.float32)
    for i in range(len(per_step) - 1, -1, -1):
        op, operand = per_step[i]
        if op.vjp is not None:
            gx, d_ops[i] = op.vjp(inputs[i], operand, gx)
            continue
        with torch.enable_grad():
            xin = inputs[i].detach().requires_grad_()
            if operand is None:
                (gx,) = torch.autograd.grad(op.apply(xin, None), (xin,), gx)
            else:
                o = operand.detach().requires_grad_()
                gx, d_ops[i] = torch.autograd.grad(op.apply(xin, o), (xin, o), gx)
    return gx, tuple(d for d in d_ops if d is not None)
