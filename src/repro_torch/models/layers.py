"""Shared building blocks (plain functions on tensors and parameter dicts).

The port of :mod:`repro.models.layers`. Every matrix multiply goes through
:func:`repro_torch.kernels.ops.matmul`, the O-POPE GEMM path. Norms compute
in fp32 whatever the parameter dtype and cast back.

Every ``backend=`` here is a backend name or a precision policy (anything
with ``backend_for(role)``, e.g. :class:`repro_torch.quant.PrecisionPolicy`);
each GEMM site resolves it for its role through :func:`role_backend`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import epilogue as _epilogue
from repro_torch.kernels import ops
from repro_torch.quant.quantize import QuantizedTensor

__all__ = [
    "ACT2FN",
    "activation_fn",
    "Initializer",
    "role_backend",
    "dense_init",
    "embedding_init",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "softcap",
    "rope_frequencies",
    "apply_rope",
    "mlp_init",
    "mlp_apply",
]

ACT2FN = _epilogue.ACTIVATIONS


def activation_fn(name: str):
    """The callable for an activation name; unknown names raise."""
    try:
        return ACT2FN[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(ACT2FN)}"
        ) from None


def role_backend(backend, role: str):
    """The backend of one layer role: ``backend`` itself when it is a name
    (or None), else ``backend.backend_for(role)`` (a precision policy)."""
    resolver = getattr(backend, "backend_for", None)
    return resolver(role) if resolver is not None else backend


@dataclasses.dataclass(frozen=True)
class Initializer:
    """Truncated-normal (±2σ) initializer: std ``fan_in**-0.5`` when a fan-in
    is given, else ``stddev``; drawn in fp32 on ``device`` from
    ``generator``, then cast to ``dtype``."""

    dtype: torch.dtype = torch.bfloat16
    stddev: float = 0.02
    device: torch.device = torch.device("cpu")
    generator: Optional[torch.Generator] = None

    def __call__(self, shape: Tuple[int, ...], fan_in: Optional[int] = None) -> torch.Tensor:
        std = self.stddev if fan_in is None else fan_in ** -0.5
        x = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=self.generator)
        return (x * std).to(self.dtype)


def dense_init(d_in: int, d_out: int, init: Initializer, *, bias: bool = False):
    p: Dict[str, torch.Tensor] = {"w": init((d_in, d_out), fan_in=d_in)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=init.dtype, device=init.device)
    return p


def embedding_init(vocab: int, d_model: int, init: Initializer):
    return {"table": init((vocab, d_model))}


def rmsnorm_init(d: int, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def layernorm_init(d: int, device, dtype=torch.float32):
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_frequencies(rotary_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotated ``rotary_dim`` (must be even)."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    rotary_frac: float = 1.0,
    theta: float = 10000.0,
) -> torch.Tensor:
    """RoPE on ``x`` [..., S, H, D] at ``positions`` [..., S].

    Rotates interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]`` of the first
    ``int(D * rotary_frac)`` dims (chatglm3's 2-D RoPE: 0.5); the rest pass
    through.
    """
    d = x.shape[-1]
    rot = int(d * rotary_frac)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_frequencies(rot, theta, x.device)
    ang = positions[..., :, None].float() * inv  # [..., S, rot/2]
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([rotated, x_pass], dim=-1) if rot < d else rotated


def mlp_init(d_model: int, d_ff: int, init: Initializer, *, gated: bool = True):
    p = {"w_up": init((d_model, d_ff), fan_in=d_model)}
    if gated:
        p["w_gate"] = init((d_model, d_ff), fan_in=d_model)
    p["w_down"] = init((d_ff, d_model), fan_in=d_ff)
    return p


def mlp_apply(
    params, x: torch.Tensor, *, activation: str = "silu", backend=None,
    role: str = "mlp", residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SwiGLU (default) / GeGLU / plain MLP on the O-POPE matmul path.

    The activation and the gating multiply ride the gate GEMM's epilogue;
    ``residual`` rides the down projection's. ``up`` is cast to ``x.dtype``
    before it becomes the ``mul`` operand, as in the reference. ``role``
    keys the policy lookup (the shared-expert MLP of an MoE block passes
    ``"moe"``). When the policy gives the role a ``requant_for`` scale and
    a q8 backend, the gate GEMM writes the hidden activation on the int8
    grid of that scale (a ``requant_int8`` epilogue step) and the down GEMM
    consumes it pre-quantized.
    """
    activation_fn(activation)
    resolver = getattr(backend, "requant_for", None)
    rq = resolver(role) if resolver is not None else None
    be = role_backend(backend, role)
    if rq is not None and ops.family_of(ops.resolve_backend(be, x.device)) != "q8":
        rq = None  # an int8 output only feeds a quantized consumer
    if "w_gate" in params:
        up = ops.matmul(x, params["w_up"], backend=be)
        hidden_ep = [activation, ("mul", up)]
        w_act = params["w_gate"]
    else:
        hidden_ep = [activation]
        w_act = params["w_up"]
    if rq is not None:
        scale = torch.tensor(rq, dtype=torch.float32, device=x.device)
        h_q = ops.matmul(x, w_act, backend=be, epilogue=[*hidden_ep, ("requant_int8", scale)],
                         out_dtype=torch.int8)
        h = QuantizedTensor(h_q, scale)
    else:
        h = ops.matmul(x, w_act, backend=be, epilogue=hidden_ep, out_dtype=x.dtype)
    down_ep = [("residual", residual)] if residual is not None else None
    return ops.matmul(h, params["w_down"], backend=be, epilogue=down_ep,
                      out_dtype=x.dtype if rq is not None else None)
