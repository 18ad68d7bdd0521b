"""xLSTM mixers (Beck et al., arXiv:2405.04517): mLSTM and sLSTM.

The port of :mod:`repro.models.xlstm`. Every projection goes through
:func:`repro_torch.kernels.ops.matmul`; the cells are plain PyTorch in
fp32, as the reference's are jnp.

* **mLSTM**: a matrix memory ``[B, H, D, D]`` with exponential gating.
  Prefill runs the chunkwise-parallel form: a Python loop over chunks of
  ``chunk`` tokens (shrunk until it divides S) carries the state, and each
  chunk adds its tokens' contributions through a masked quadratic, in log
  space with the running max-gate stabiliser.
* **sLSTM**: a scalar memory with a block-diagonal recurrent mix
  ``r [H, hd, 4 hd]``; it is sequential, so prefill is a Python loop over
  tokens.

Both decode one token from an explicit state (:class:`MLSTMState`,
:class:`SLSTMState`), whose size does not depend on the sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.opope_gemm import full_fp32
from .layers import Initializer

__all__ = [
    "MLSTMState",
    "SLSTMState",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_decode_step",
    "slstm_init",
    "slstm_apply",
    "slstm_decode_step",
]

_M_INIT = -1e30  # the stabiliser's start: no gate seen yet


@dataclasses.dataclass
class MLSTMState:
    """``c [B, H, D, D]`` matrix memory, ``n [B, H, D]`` normalizer and
    ``m [B, H]`` running log-gate max, all fp32."""

    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def zeros(batch: int, n_heads: int, head_dim: int, device) -> "MLSTMState":
        f32 = dict(dtype=torch.float32, device=device)
        return MLSTMState(
            c=torch.zeros((batch, n_heads, head_dim, head_dim), **f32),
            n=torch.zeros((batch, n_heads, head_dim), **f32),
            m=torch.full((batch, n_heads), _M_INIT, **f32),
        )


@dataclasses.dataclass
class SLSTMState:
    """Cell ``c``, normalizer ``n``, hidden ``h`` and stabiliser ``m``, each
    ``[B, H, D]`` fp32."""

    c: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def zeros(batch: int, n_heads: int, head_dim: int, device) -> "SLSTMState":
        z = torch.zeros((batch, n_heads, head_dim), dtype=torch.float32, device=device)
        return SLSTMState(c=z, n=z.clone(), h=z.clone(), m=z - 1e30)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(d_model: int, n_heads: int, init: Initializer):
    return {
        "wq": init((d_model, d_model), fan_in=d_model),
        "wk": init((d_model, d_model), fan_in=d_model),
        "wv": init((d_model, d_model), fan_in=d_model),
        "w_if": init((d_model, 2 * n_heads), fan_in=d_model),
        "b_if": torch.zeros((2 * n_heads,), dtype=torch.float32, device=init.device),
        "w_o": init((d_model, d_model), fan_in=d_model),
        "ogate": init((d_model, d_model), fan_in=d_model),
    }


def _mlstm_qkv(params, x: torch.Tensor, n_heads: int, backend):
    """q, k, v [B, S, H, hd] and the input and forget gates' fp32
    pre-activations [B, S, H]."""
    b, s, d = x.shape
    hd = d // n_heads
    q = ops.matmul(x, params["wq"], backend=backend).reshape(b, s, n_heads, hd)
    k = ops.matmul(x, params["wk"], backend=backend).reshape(b, s, n_heads, hd)
    v = ops.matmul(x, params["wv"], backend=backend).reshape(b, s, n_heads, hd)
    gates = ops.matmul(x, params["w_if"], backend=backend).float() + params["b_if"]
    gates = gates.reshape(b, s, 2, n_heads)
    return q, k, v, gates[:, :, 0], gates[:, :, 1]


def _mlstm_chunk(state, qk, kk, vk, ik, lfk, hd: int):
    """One chunk of the chunkwise-parallel form: the chunk's outputs
    ``[B, ck, H, hd]`` and the state at its end."""
    c, n, m = state  # [B,H,hd,hd], [B,H,hd], [B,H]
    ck = qk.shape[1]
    lf_cum = torch.cumsum(lfk, dim=1)  # [B, ck, H] inclusive
    lf_tot = lf_cum[:, -1]  # [B, H]
    # Log weight of token t's contribution at the chunk's end.
    a = ik + (lf_tot[:, None] - lf_cum)  # [B, ck, H]
    m_new = torch.maximum(lf_tot + m, a.amax(dim=1))
    # Pairwise weights inside the chunk, D_ts = i_s + lf_cum_t - lf_cum_s (s <= t).
    dmat = ik[:, None, :, :] + lf_cum[:, :, None, :] - lf_cum[:, None, :, :]  # [B,t,s,H]
    upper = ~torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=qk.device))
    dmat = dmat.masked_fill(upper[None, :, :, None], float("-inf"))
    m_intra = torch.maximum(dmat.amax(dim=2), (lf_cum + m[:, None]) - 1e-9)
    m_t = torch.maximum(m_intra, m[:, None] + lf_cum)  # [B, ck, H]
    w = torch.exp(dmat - m_t[:, :, None, :])  # [B, t, s, H]
    qf = qk.float() * hd ** -0.5
    kf, vf = kk.float(), vk.float()
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * w
    intra = torch.einsum("btsh,bshd->bthd", scores, vf)
    intra_n = torch.einsum("btsh,bshd->bthd", scores, torch.ones_like(kf)[..., :1])
    # The carried state's contribution, decayed to position t.
    w_inter = torch.exp(m[:, None] + lf_cum - m_t)  # [B, ck, H]
    inter = torch.einsum("bthd,bhde->bthe", qf, c) * w_inter[..., None]
    inter_n = torch.einsum("bthd,bhd->bth", qf, n) * w_inter
    num = intra + inter
    den = torch.abs(intra_n[..., 0] + inter_n)
    h_t = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    # The state at the chunk's end.
    wa = torch.exp(a - m_new[:, None])  # [B, ck, H]
    decay = torch.exp(m + lf_tot - m_new)
    c_new = c * decay[..., None, None] + torch.einsum("bshd,bsh,bshe->bhde", kf, wa, vf)
    n_new = n * decay[..., None] + torch.einsum("bshd,bsh->bhd", kf, wa)
    return (c_new, n_new, m_new), h_t


def mlstm_apply(params, x: torch.Tensor, *, n_heads: int, chunk: int = 64, backend=None,
                return_state: bool = False):
    """Chunkwise-parallel mLSTM. x: [B, S, D] -> [B, S, D]; with
    ``return_state`` also the :class:`MLSTMState` after the last token."""
    b, s, d = x.shape
    hd = d // n_heads
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x, n_heads, backend)
    logf = F.logsigmoid(f_pre)  # [B, S, H]
    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    init = MLSTMState.zeros(b, n_heads, hd, x.device)
    state = (init.c, init.n, init.m)
    hs = []
    with full_fp32():
        for lo in range(0, s, ck):
            sl = slice(lo, lo + ck)
            state, h_t = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                                      logf[:, sl], hd)
            hs.append(h_t)
    hs = torch.cat(hs, dim=1).reshape(b, s, d)
    og = torch.sigmoid(ops.matmul(x, params["ogate"], backend=backend).float())
    out = ops.matmul((hs * og).to(x.dtype), params["w_o"], backend=backend)
    if return_state:
        return out, MLSTMState(*state)
    return out


def mlstm_decode_step(params, x: torch.Tensor, state: MLSTMState, *, n_heads: int,
                      backend=None) -> Tuple[torch.Tensor, MLSTMState]:
    """The exact one-token mLSTM recurrence. x: [B, 1, D]."""
    b, _, d = x.shape
    hd = d // n_heads
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x, n_heads, backend)
    qf = q[:, 0].float() * hd ** -0.5  # [B, H, hd]
    kf, vf = k[:, 0].float(), v[:, 0].float()
    i_t, lf_t = i_pre[:, 0], F.logsigmoid(f_pre[:, 0])  # [B, H]
    m_new = torch.maximum(state.m + lf_t, i_t)
    wf = torch.exp(state.m + lf_t - m_new)[..., None]
    wi = torch.exp(i_t - m_new)[..., None]
    c_new = state.c * wf[..., None] + (kf * wi)[..., :, None] * vf[..., None, :]
    n_new = state.n * wf + kf * wi
    with full_fp32():
        num = torch.einsum("bhd,bhde->bhe", qf, c_new)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    og = torch.sigmoid(ops.matmul(x, params["ogate"], backend=backend).float())
    out = (h.reshape(b, 1, d) * og).to(x.dtype)
    return (ops.matmul(out, params["w_o"], backend=backend),
            MLSTMState(c=c_new, n=n_new, m=m_new))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(d_model: int, n_heads: int, init: Initializer):
    hd = d_model // n_heads
    return {
        # One input projection for the i, f, z, o pre-activations.
        "w_x": init((d_model, 4 * d_model), fan_in=d_model),
        "b": torch.zeros((4 * d_model,), dtype=torch.float32, device=init.device),
        # The per-head (block-diagonal) recurrent mix of h_{t-1}.
        "r": init((n_heads, hd, 4 * hd), fan_in=hd),
        "w_o": init((d_model, d_model), fan_in=d_model),
    }


def _slstm_cell(params, xw_t: torch.Tensor, state: SLSTMState, n_heads: int) -> SLSTMState:
    """One sLSTM step. xw_t: [B, 4D], the input's projection, laid out as
    ``[i | f | z | o]`` blocks of D."""
    b = xw_t.shape[0]
    d = xw_t.shape[1] // 4
    hd = d // n_heads
    with full_fp32():
        rec = torch.einsum("bhd,hdk->bhk", state.h, params["r"].float())  # [B, H, 4hd]
    pre = (
        xw_t.float().reshape(b, 4, n_heads, hd).permute(0, 2, 1, 3)
        + rec.reshape(b, n_heads, 4, hd)
        + params["b"].reshape(4, n_heads, hd).permute(1, 0, 2)[None]
    )  # [B, H, 4, hd]
    i_pre, f_pre, z_pre, o_pre = (pre[:, :, j] for j in range(4))
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(state.m + lf, i_pre)
    wf = torch.exp(state.m + lf - m_new)
    wi = torch.exp(i_pre - m_new)
    c_new = wf * state.c + wi * torch.tanh(z_pre)
    n_new = wf * state.n + wi
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


def slstm_apply(params, x: torch.Tensor, *, n_heads: int, backend=None,
                return_state: bool = False):
    """The sLSTM over the sequence, one token at a time. x: [B, S, D] ->
    [B, S, D]; with ``return_state`` also the :class:`SLSTMState` after the
    last token."""
    b, s, d = x.shape
    xw = ops.matmul(x, params["w_x"], backend=backend)  # [B, S, 4D]
    state = SLSTMState.zeros(b, n_heads, d // n_heads, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, xw[:, t], state, n_heads)
        hs.append(state.h)
    hs = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = ops.matmul(hs, params["w_o"], backend=backend)
    if return_state:
        return out, state
    return out


def slstm_decode_step(params, x: torch.Tensor, state: SLSTMState, *, n_heads: int,
                      backend=None) -> Tuple[torch.Tensor, SLSTMState]:
    b, _, d = x.shape
    xw = ops.matmul(x, params["w_x"], backend=backend)[:, 0]
    new = _slstm_cell(params, xw, state, n_heads)
    h = new.h.reshape(b, 1, d).to(x.dtype)
    return ops.matmul(h, params["w_o"], backend=backend), new
