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
and as the reference on the card) and a fixed integer code that the CUDA
kernels (``csrc/opope_tile.cuh``) switch on. The names, kinds and fp32
arithmetic match the JAX registry op for op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "EpilogueOp",
    "ACTIVATIONS",
    "OP_CODES",
    "KIND_CODES",
    "epilogue_ops",
    "op_def",
    "op_kind",
    "normalize_epilogue",
    "canonicalize_operands",
    "apply_epilogue",
]

ApplyFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]

KIND_CODES: Dict[str, int] = {"none": 0, "scalar": 1, "row": 2, "full": 3}


@dataclasses.dataclass(frozen=True)
class EpilogueOp:
    """One registered post-op: name, operand kind, fp32 apply, kernel code."""

    name: str
    kind: str
    apply: ApplyFn
    code: int


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


_REGISTRY: Dict[str, EpilogueOp] = {}


def _register(name: str, kind: str, apply: ApplyFn) -> None:
    _REGISTRY[name] = EpilogueOp(name, kind, apply, code=len(_REGISTRY))


for _name, _fn in ACTIVATIONS.items():
    _register(_name, "none", lambda acc, _o, _f=_fn: _f(acc))
_register("bias", "row", lambda acc, o: acc + o)
_register("residual", "full", lambda acc, o: acc + o)
_register("mul", "full", lambda acc, o: acc * o)
_register("scale", "row", lambda acc, o: acc * o)
_register("requant_int8", "scalar", _requant_int8)

# gelu 0, silu 1, swish 2, relu 3, bias 4, residual 5, mul 6, scale 7,
# requant_int8 8 — the enum in csrc/opope_tile.cuh.
OP_CODES: Dict[str, int] = {name: op.code for name, op in _REGISTRY.items()}


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
