"""Mixture-of-Experts FFN with two dispatch strategies.

The port of :mod:`repro.models.moe`.

* ``"onehot"`` — the GShard/Switch formulation: dispatch/combine one-hot
  einsums over [tokens, experts, capacity] (the reference's paper-faithful
  baseline, and what the published configs use).
* ``"sort"`` — sort token assignments by expert (a stable sort), scatter
  into per-expert capacity buffers, run the expert GEMMs, gather back.

Both honour capacity: assignments past ``capacity_factor * g * top_k / E``
per expert in a routing group are dropped, in token order. Expert weights
are stacked [E, ...]. The per-expert SwiGLU (:func:`_expert_ffn`) runs as
grouped O-POPE GEMMs (``ops.grouped_matmul``, expert axis = group axis): on
the card, the hand-written grouped kernel.

Routing follows the reference to the bit where it can: the router logits
come out of the GEMM in the activation dtype (bf16 at full width) before the
fp32 softmax, so equal gates are common; top-k takes the lower expert index
on ties (a stable descending sort, as ``jax.lax.top_k``), and the sort
dispatch orders equal expert ids by token (a stable argsort, as
``jnp.argsort``). Sums over several experts (the combine) may differ from
the reference in the last fp32 bits: the order of a sum differs, and on the
card ``index_add_`` adds with atomics.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.opope_gemm import full_fp32
from .layers import Initializer, mlp_apply, mlp_init, role_backend

__all__ = ["moe_init", "moe_apply", "router_load_balancing_loss"]


def moe_init(
    d_model: int,
    d_ff_expert: int,
    n_experts: int,
    init: Initializer,
    *,
    n_shared: int = 0,
    d_ff_shared: Optional[int] = None,
):
    p = {
        "router": init((d_model, n_experts), fan_in=d_model),
        "w_gate": init((n_experts, d_model, d_ff_expert), fan_in=d_model),
        "w_up": init((n_experts, d_model, d_ff_expert), fan_in=d_model),
        "w_down": init((n_experts, d_ff_expert, d_model), fan_in=d_ff_expert),
    }
    if n_shared:
        p["shared"] = mlp_init(d_model, d_ff_shared or n_shared * d_ff_expert, init)
    return p


def _expert_ffn(p, xs: torch.Tensor, *, backend=None, out_dtype=None) -> torch.Tensor:
    """xs: [E, C, D] -> [E, C, D]; batched per-expert SwiGLU on stacked
    weights, three grouped GEMMs. SiLU and the gating multiply ride the gate
    GEMM's epilogue; ``out_dtype`` is the down projection's writeback type
    (fp32 for the dispatch paths, which combine in fp32)."""
    up = ops.grouped_matmul(xs, p["w_up"], backend=backend)
    h = ops.grouped_matmul(
        xs, p["w_gate"], backend=backend,
        epilogue=["silu", ("mul", up)], out_dtype=xs.dtype,
    )
    return ops.grouped_matmul(h, p["w_down"], backend=backend, out_dtype=out_dtype)


def router_load_balancing_loss(gates: torch.Tensor, expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (fp32)."""
    e = gates.shape[-1]
    f = expert_mask.float().reshape(-1, e).mean(0)
    p = gates.float().reshape(-1, e).mean(0)
    return e * torch.sum(f * p)


def _route(params, xf: torch.Tensor, top_k: int, backend=None):
    """Router GEMM, fp32 softmax and top-k: (gates [T, E], renormalised
    top_vals [T, K], top_idx [T, K]). The logits are rounded to ``xf.dtype``
    by the GEMM's single cast before the softmax, as in the reference."""
    logits = ops.matmul(xf, params["router"], backend=backend).float()
    gates = torch.softmax(logits, dim=-1)
    # Stable descending sort: equal gates keep the lower expert index first.
    top_vals, top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :top_k], top_idx[:, :top_k]
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    return gates, top_vals, top_idx


def moe_apply(
    params,
    x: torch.Tensor,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    dispatch: str = "sort",
    group_size: int = 512,
    dropless: bool = False,
    backend=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss).

    Tokens are routed in groups of ``group_size`` with per-group capacity
    (GShard semantics). ``dropless=True`` sets capacity to the group size,
    so no assignment can overflow. With shared experts, the routed sum rides
    the shared MLP's down projection as its ``residual`` epilogue. Policy
    roles: the router GEMM ``router``; the routed experts and the shared
    MLP ``moe``.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, top_vals, top_idx = _route(params, xf, top_k, role_backend(backend, "router"))
    # Routing groups: the largest divisor of T that is <= group_size.
    g = min(group_size, t)
    while t % g:
        g -= 1
    n_groups = t // g
    if dropless:
        capacity = g
    else:
        capacity = max(int(math.ceil(capacity_factor * g * top_k / n_experts)), 1)
    xg = xf.reshape(n_groups, g, d)
    vg = top_vals.reshape(n_groups, g, top_k)
    ig = top_idx.reshape(n_groups, g, top_k)
    expert_be = role_backend(backend, "moe")
    if dispatch == "onehot":
        y = _dispatch_onehot(params, xg, vg, ig, n_experts, capacity, expert_be)
    elif dispatch == "sort":
        y = _dispatch_sort(params, xg, vg, ig, n_experts, capacity, expert_be)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    y = y.reshape(t, d)
    if "shared" in params:
        y = mlp_apply(params["shared"], xf, backend=backend, role="moe", residual=y)
    mask = _one_hot(top_idx, n_experts, torch.float32).sum(1)
    aux = router_load_balancing_loss(gates, mask)
    return y.reshape(b, s, d), aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _positions_in_expert(ig: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Per-group rank of each assignment within its expert, in token-major
    order. ig: [G, g, K]."""
    ohf = _one_hot(ig.reshape(ig.shape[0], -1), n_experts, torch.int64)  # [G, g*K, E]
    pos = torch.cumsum(ohf, dim=1) - 1
    return (pos * ohf).sum(-1).reshape(ig.shape)


def _dispatch_onehot(params, xg, vg, ig, n_experts, capacity, backend=None):
    """GShard one-hot dispatch/combine einsums (the dense baseline). The
    dispatch einsum only copies values (one non-zero term per output); the
    combine is an fp32 einsum over the experts' fp32 outputs."""
    pos = _positions_in_expert(ig, n_experts)  # [G, g, K]
    keep = pos < capacity
    oh_e = _one_hot(ig, n_experts, xg.dtype)  # [G, g, K, E]
    oh_c = _one_hot(pos, capacity, xg.dtype)  # [G, g, K, C]
    disp = torch.einsum("gske,gskc->gsec", oh_e * keep[..., None].to(xg.dtype), oh_c)
    with full_fp32():
        comb = torch.einsum(
            "gske,gskc->gsec", oh_e.float() * (vg * keep)[..., None], oh_c.float()
        )
    expert_in = torch.einsum("gsec,gsd->gecd", disp, xg)
    e, c, d = n_experts, capacity, xg.shape[-1]
    expert_out = _expert_ffn(
        params, expert_in.permute(1, 0, 2, 3).reshape(e, -1, d),
        backend=backend, out_dtype=torch.float32,
    ).reshape(e, -1, c, d).permute(1, 0, 2, 3)  # [G, E, C, D] fp32
    with full_fp32():
        return torch.einsum("gsec,gecd->gsd", comb, expert_out).to(xg.dtype)


def _dispatch_sort(params, xg, vg, ig, n_experts, capacity, backend=None):
    """Per-group sort-scatter dispatch: a stable sort by expert, a scatter
    into [E * C] capacity rows (dropped assignments go to a dump row that is
    cut off), the expert GEMMs, and an fp32 gather-add back to the tokens."""
    n_groups, g, d = xg.shape
    k = ig.shape[-1]
    dev = xg.device
    e_flat = ig.reshape(n_groups, g * k)
    tok_flat = torch.arange(g, device=dev).repeat_interleave(k).expand(n_groups, -1)
    w_flat = vg.reshape(n_groups, g * k)

    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    tok_sorted = torch.gather(tok_flat, 1, order)
    w_sorted = torch.gather(w_flat, 1, order)
    experts = torch.arange(n_experts, device=dev).expand(n_groups, -1).contiguous()
    seg_start = torch.searchsorted(e_sorted.contiguous(), experts)  # [G, E]
    rank = torch.arange(g * k, device=dev)[None] - torch.gather(seg_start, 1, e_sorted)
    keep = rank < capacity
    dump = n_experts * capacity
    dest = torch.where(keep, e_sorted * capacity + rank, torch.full_like(rank, dump))

    expert_in = torch.zeros((n_groups, dump + 1, d), dtype=xg.dtype, device=dev)
    for grp in range(n_groups):
        expert_in[grp, dest[grp]] = xg[grp, tok_sorted[grp]]
    expert_in = expert_in[:, :dump].reshape(n_groups, n_experts, capacity, d)
    expert_out = _expert_ffn(
        params, expert_in.permute(1, 0, 2, 3).reshape(n_experts, -1, d),
        backend=backend, out_dtype=torch.float32,
    ).reshape(n_experts, n_groups, capacity, d).permute(1, 0, 2, 3)

    y = torch.zeros((n_groups, g, d), dtype=torch.float32, device=dev)
    for grp in range(n_groups):
        flat = torch.cat([expert_out[grp].reshape(dump, d),
                          torch.zeros((1, d), dtype=torch.float32, device=dev)])
        y_sorted = flat[dest[grp]] * w_sorted[grp][:, None]
        y[grp].index_add_(0, tok_sorted[grp], y_sorted)
    return y.to(xg.dtype)
