"""Mamba (S6) selective-state-space mixer: jamba's sequence layer.

The port of :mod:`repro.models.mamba`. The projections (``in_proj``,
``x_proj``, ``dt_proj``, ``out_proj``) go through
:func:`repro_torch.kernels.ops.matmul`; the depthwise causal conv and the
selective scan are plain PyTorch, as the reference's are jnp and not a
Pallas kernel. The scan is state-resident and chunked: the sequence is cut
into chunks of ``chunk`` tokens (shrunk until it divides S, as the
reference's), a log-step (Hillis–Steele) prefix scan of the discretized
``(exp(dt·A), dt·B·x)`` pairs runs inside each chunk in fp32, and a Python
loop carries the ``[B, d_inner, d_state]`` state from one chunk to the next.
Only one chunk's ``[B, chunk, d_inner, d_state]`` expansion exists at a
time: where autograd records, each chunk's step runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its chunk
step), so the backward keeps the chunk's inputs and carried state and
recomputes its expansion one chunk at a time. The prefix scan combines the
same pairs as the reference's ``jax.lax.associative_scan`` in another
order, so the two agree to fp32 rounding, not bitwise.

Decode is the exact one-token recurrence from a :class:`MambaState` (the
conv window and the ssm state). As in the reference, the decode step's
``x_proj`` and ``dt_proj`` run on the default backend, not on the
``backend`` passed in (``repro/models/mamba.py:77``, ``_ssm_inputs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.opope_gemm import full_fp32
from .layers import Initializer, activation_fn

__all__ = ["MambaState", "mamba_init", "mamba_apply", "mamba_decode_step"]

_silu = activation_fn("silu")


@dataclasses.dataclass
class MambaState:
    """Decode cache: the conv window ``[B, d_conv - 1, d_inner]`` (the
    activations' dtype) and the ssm state ``[B, d_inner, d_state]`` (fp32)."""

    conv: torch.Tensor
    ssm: torch.Tensor

    @staticmethod
    def zeros(batch: int, d_inner: int, d_state: int, d_conv: int, dtype, device) -> "MambaState":
        return MambaState(
            conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            ssm=torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
        )


def mamba_init(d_model: int, init: Initializer, *, expand: int = 2, d_state: int = 16,
               d_conv: int = 4, dt_rank: Optional[int] = None):
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, math.ceil(d_model / 16))
    f32 = dict(dtype=torch.float32, device=init.device)
    return {
        "in_proj": init((d_model, 2 * d_inner), fan_in=d_model),
        "conv_w": init((d_conv, d_inner), fan_in=d_conv),
        "conv_b": torch.zeros((d_inner,), dtype=init.dtype, device=init.device),
        "x_proj": init((d_inner, dt_rank + 2 * d_state), fan_in=d_inner),
        "dt_proj": init((dt_rank, d_inner), fan_in=dt_rank),
        "dt_bias": torch.zeros((d_inner,), **f32),
        # A kept as its log; D is the skip gain.
        "A_log": torch.log(torch.arange(1, d_state + 1, **f32).repeat(d_inner, 1)),
        "D": torch.ones((d_inner,), **f32),
        "out_proj": init((d_inner, d_model), fan_in=d_inner),
    }


def _dt_b_c(params, xc: torch.Tensor, backend):
    """``x_proj`` of the conv output split into (dt, B, C), dt through
    ``dt_proj`` and the softplus: fp32 ``dt [..., Di]``, ``B``, ``C [..., N]``."""
    d_state = params["A_log"].shape[1]
    dt_rank = params["x_proj"].shape[1] - 2 * d_state
    proj = ops.matmul(xc, params["x_proj"], backend=backend).float()
    dt, bmat, cmat = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(
        ops.matmul(dt.to(xc.dtype), params["dt_proj"], backend=backend).float()
        + params["dt_bias"]
    )
    return dt, bmat, cmat


def _conv1d_causal(params, x: torch.Tensor, history: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence with silu. x: [B, S, Di],
    ``history`` the [B, d_conv - 1, Di] window before it (zeros without)."""
    w = params["conv_w"].float()  # [K, Di]
    kw = w.shape[0]
    pad = (history.float() if history is not None
           else torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=torch.float32,
                            device=x.device))
    xp = torch.cat([pad, x.float()], dim=1)
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, kw):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return _silu(out + params["conv_b"].float()).to(x.dtype)


def _prefix_scan(da: torch.Tensor, dbx: torch.Tensor):
    """Inclusive scan of the pairs ``(a, b)`` along dim 1 under
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, in ceil(log2(len))
    out-of-place steps."""
    n, d = da.shape[1], 1
    while d < n:
        a_t = da[:, d:]
        da, dbx = (torch.cat([da[:, :d], da[:, :-d] * a_t], dim=1),
                   torch.cat([dbx[:, :d], dbx[:, :-d] * a_t + dbx[:, d:]], dim=1))
        d *= 2
    return da, dbx


def _chunk_step(a, h, dt_k, x_k, b_k, c_k):
    """One chunk of the scan from the carried state ``h [B, Di, N]``: the
    new state and the chunk's output ``[B, ck, Di]``. Its
    ``[B, ck, Di, N]`` expansion lives only inside the call."""
    with full_fp32():
        da_k = torch.exp(dt_k[..., None] * a)  # [B, ck, Di, N]
        dbx_k = (dt_k * x_k)[..., None] * b_k[:, :, None, :]
        a_cum, b_cum = _prefix_scan(da_k, dbx_k)
        hs = a_cum * h[:, None] + b_cum  # [B, ck, Di, N]
        # A copy, not a view: a view would keep hs alive with the state.
        return hs[:, -1].clone(), torch.einsum("bsdn,bsn->bsd", hs, c_k)


def mamba_apply(params, x: torch.Tensor, *, chunk: int = 64, backend=None,
                return_state: bool = False):
    """Full-sequence selective scan. x: [B, S, D] -> [B, S, D]; with
    ``return_state`` also the :class:`MambaState` after the last token (the
    conv window zero-padded on the left when S < d_conv - 1)."""
    b, s, _ = x.shape
    xi = ops.matmul(x, params["in_proj"], backend=backend)
    xm, z = torch.chunk(xi, 2, dim=-1)  # [B, S, Di] each
    xc = _conv1d_causal(params, xm)
    dt, bmat, cmat = _dt_b_c(params, xc, backend)  # [B,S,Di], [B,S,N], [B,S,N]
    a = -torch.exp(params["A_log"])  # [Di, N]
    xc_f = xc.float()

    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    h = torch.zeros((b, dt.shape[-1], a.shape[1]), dtype=torch.float32, device=x.device)
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (a, dt, xc_f, bmat, cmat))
    ys = []
    for lo in range(0, s, ck):
        args = (a, h, dt[:, lo:lo + ck], xc_f[:, lo:lo + ck], bmat[:, lo:lo + ck],
                cmat[:, lo:lo + ck])
        if recorded:
            h, y_k = torch.utils.checkpoint.checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            h, y_k = _chunk_step(*args)
        ys.append(y_k)
    y = torch.cat(ys, dim=1)
    y = y + params["D"] * xc_f
    y = (y * _silu(z.float())).to(x.dtype)
    out = ops.matmul(y, params["out_proj"], backend=backend)
    if not return_state:
        return out
    kw = params["conv_w"].shape[0]
    if s >= kw - 1:
        conv_hist = xm[:, s - (kw - 1):]
    else:  # a prompt shorter than the window: zeros on the left
        conv_hist = torch.cat([torch.zeros((b, kw - 1 - s, xm.shape[2]), dtype=xm.dtype,
                                           device=xm.device), xm], dim=1)
    # A copy: a view of xm would keep the whole in_proj output alive.
    return out, MambaState(conv=conv_hist.contiguous(), ssm=h)


def mamba_decode_step(params, x: torch.Tensor, state: MambaState, *, backend=None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrence. x: [B, 1, D] -> ([B, 1, D], the new state)."""
    xi = ops.matmul(x, params["in_proj"], backend=backend)
    xm, z = torch.chunk(xi, 2, dim=-1)
    xc = _conv1d_causal(params, xm, history=state.conv)
    new_conv = torch.cat([state.conv[:, 1:], xm], dim=1)
    # The reference's decode step runs x_proj and dt_proj on the default
    # backend.
    dt, bmat, cmat = _dt_b_c(params, xc[:, 0], None)  # [B, Di], [B, N], [B, N]
    da = torch.exp(dt[..., None] * -torch.exp(params["A_log"]))
    dbx = (dt * xc[:, 0].float())[..., None] * bmat[:, None, :]
    h = da * state.ssm + dbx
    with full_fp32():
        y = torch.einsum("bdn,bn->bd", h, cmat)
    y = y + params["D"] * xc[:, 0].float()
    y = (y * _silu(z[:, 0].float())).to(x.dtype)
    out = ops.matmul(y[:, None], params["out_proj"], backend=backend)
    return out, MambaState(conv=new_conv, ssm=h)
