"""Flash attention (K3): the hand-written CUDA kernel and its plain version.

Ports :func:`repro.kernels.opope_attention.opope_attention` and
``opope_attention_bhsd`` (the Pallas TPU kernel ``_attn_kernel``). All
functions here compute single-head softmax attention per (batch, head):

* scale ``D**-0.5``; scores and the softmax state in fp32; the
  probabilities are cast to ``v.dtype`` before the P·V product, which
  accumulates in fp32; the output is ``acc / max(l, 1e-37)`` cast to
  ``q.dtype``;
* keys at or past T are masked, and a causal mask is aligned to the end of
  the keys (query row ``r`` sees keys ``<= r + T - S``), with the finite
  ``NEG_INF`` of the reference;
* a causal query row with no valid key (``r + T - S < 0``, only when
  S > T) gives what the reference kernel gives: with its finite ``NEG_INF``
  every key of each panel its query block visits weighs 1, padded keys
  included, so ``out[r] = sum(v[:min(L, T)]) / L`` with ``L`` the keys in
  those panels (0 when there are none, then the row is 0). Only these rows
  depend on ``block_q``/``block_k``, the reference's block sizes; every
  other row is independent of them.

* :func:`opope_attention` (q [S, D], k/v [T, D]) and
  :func:`opope_attention_bhsd` (q [B, H, S, D], k/v [B, H, T, D], one
  launch over all B·H heads) launch ``csrc/opope_attention.cu`` for tensors
  on the card and raise on what the kernel does not take: one dtype of
  fp32, bf16, fp16, e4m3 and e5m2 for q, k and v, at any head dim. Given
  tensors on the CPU they run :func:`opope_attention_plain`: the kernel has
  no CPU form.
  ``opope_attention.launches`` counts the kernel's launches from both, and
  ``opope_attention.launches_by_route`` splits them by route.
* :func:`_plan` chooses the route before the launch, from the operands
  alone: ``"sm90"`` (TMA ring, ``wgmma``, a producer warp; 128-row query
  tiles) for bf16 q, k, v of head dim 64 or 128 that a TMA tensor map
  describes, except a causal call with S > T; ``"tile"`` (``mma.sync`` on
  64-row tiles in bf16 or fp16, the 8-bit floats widened to fp16 on load,
  fp32 on CUDA cores; any head dim, in chunks and output passes of 128
  columns past 128; 8-bit v in two passes over each of the reference's KV
  panels, the first for its maximum) for everything else.
* :func:`opope_attention_plain` is a straightforward fp32 softmax over the
  whole key range with the same masks and ``NEG_INF``, P cast to
  ``v.dtype`` where the reference casts it (at the running maximum through
  each of its ``block_k``-key panels), and the closed form above for rows
  with no valid key: the CPU path and the reference the kernel is held
  against on the card.

Where P rounds matters at 3 or 2 mantissa bits. The tile route's 8-bit
calls round it as the reference and the plain version do; bf16 and fp16
calls round it at the running maximum through each of the kernel's own
panels (64 keys on ``tile``, 128 on ``sm90``), one rounding of P in an 8-
or 11-bit mantissa away.

P's cast to ``v.dtype`` and the output's to ``q.dtype`` follow K1's rule
(:func:`.epilogue.cast_out`): round to nearest even, e4m3 past 448 NaN.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build as _build
from .epilogue import cast_out
from .opope_gemm import FP8_DTYPES, full_fp32

__all__ = ["opope_attention", "opope_attention_bhsd", "opope_attention_plain"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# dtype codes shared with csrc/opope_attention.cu (K1's, csrc/dtypes.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}


class _Params(ctypes.Structure):
    """Mirror of ``struct AttnParams`` in csrc/opope_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p),
        ("q_strides", ctypes.c_int64 * 3), ("k_strides", ctypes.c_int64 * 3),
        ("v_strides", ctypes.c_int64 * 3), ("o_strides", ctypes.c_int64 * 3),
        ("batch_heads", ctypes.c_int), ("heads", ctypes.c_int),
        ("s", ctypes.c_int), ("t", ctypes.c_int), ("d", ctypes.c_int),
        ("dtype", ctypes.c_int), ("causal", ctypes.c_int),
        ("ref_bq", ctypes.c_int), ("ref_bk", ctypes.c_int), ("ref_kv_steps", ctypes.c_int),
        ("vec", ctypes.c_int * 3), ("scale", ctypes.c_float),
    ]


class _Maps(ctypes.Structure):
    """Mirror of ``struct AttnMaps`` in csrc/opope_attention.cu: q's, k's and
    v's tensor maps as :func:`_tma_map` gives them."""

    _fields_ = [("dims", (ctypes.c_uint64 * 4) * 3), ("strides", (ctypes.c_uint64 * 3) * 3)]


def _launcher(route: str):
    lib = _build.load("opope_attention")
    if route == "sm90":
        fn = lib.opope_attention_sm90_launch
        argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(_Maps), ctypes.c_void_p]
    else:
        fn = lib.opope_attention_launch
        argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_SM90_HEAD_DIMS = (64, 128)
_TMA_MAX_STRIDE = 1 << 40  # bytes; cuTensorMapEncodeTiled's limit

TensorMap = Tuple[Tuple[int, int, int, int], Tuple[int, int, int]]


class Plan(NamedTuple):
    """How one K3 call runs. ``maps`` (sm90 only) are q's, k's and v's
    tensor maps as :func:`_tma_map` gives them."""

    route: str  # "sm90" or "tile"
    maps: Optional[Tuple[TensorMap, TensorMap, TensorMap]]


def _tma_map(shape: Sequence[int], strides: Sequence[int], elem: int) -> Optional[TensorMap]:
    """The rank-4 TMA tensor map of a ``[B, H, N, D]`` operand: dims
    ``(D, N, H, B)`` and byte strides along ``(N, H, B)``, or None where a
    map cannot describe it. The stride along D must be 1; every other byte
    stride a positive multiple of 16 below 2**40. A dim of size 1 is never
    stepped along, so its stride is set to the next inner dim's extent
    (what a contiguous tensor has), whatever the tensor says."""
    b, h, n, d = shape
    sb, sh, sn, sd = strides
    if sd != 1:
        return None
    out = []
    inner = d * elem
    for size, stride in ((n, sn), (h, sh), (b, sb)):
        nbytes = stride * elem if size > 1 else inner
        if nbytes <= 0 or nbytes % 16 or nbytes >= _TMA_MAX_STRIDE:
            return None
        out.append(nbytes)
        inner = nbytes * size
    return (d, n, h, b), tuple(out)


def _plan(q_shape: Sequence[int], t: int, dtype: torch.dtype, causal: bool,
          strides: Sequence[Sequence[int]], ptrs: Sequence[int]) -> Plan:
    """The route of one K3 call over q ``q_shape`` = [B, H, S, D] and k/v
    [B, H, T, D], whose element strides are ``strides`` (q's, k's, v's)
    and base addresses ``ptrs``.

    ``"sm90"`` takes bf16 q, k and v of head dim 64 or 128 whose bases are
    16-byte aligned and whose layouts a TMA tensor map describes
    (:func:`_tma_map`), unless the call is causal with S > T: rows without
    a valid key follow the reference's block sizes, which only the tile
    route reproduces. Everything else takes ``"tile"``: fp32 (``wgmma``
    would run it as TF32), head dims 16 and 32, those causal calls, and
    operands TMA cannot describe (a stride of 0, such as KV heads widened
    by ``expand``, among them). The decode row (S = 1) takes ``"sm90"``
    too: measured beside the tile route in the same run, it is the faster
    of the two there as well (``PERF.md``), so no S threshold applies.
    A pure function of its arguments; only the bases' alignment enters."""
    return _plan_aligned(tuple(q_shape), int(t), dtype, bool(causal),
                         tuple(tuple(st) for st in strides), all(p % 16 == 0 for p in ptrs))


@functools.lru_cache(maxsize=4096)
def _plan_aligned(q_shape, t, dtype, causal, strides, aligned) -> Plan:
    b, h, s, d = q_shape
    maps = None
    if (dtype == torch.bfloat16 and d in _SM90_HEAD_DIMS and aligned
            and not (causal and s > t)):
        maps = tuple(_tma_map((b, h, n, d), st, 2) for n, st in zip((s, t, t), strides))
        if any(m is None for m in maps):
            maps = None
    return Plan("tile", None) if maps is None else Plan("sm90", maps)


def _ref_blocks(s: int, t: int, block_q: int, block_k: int):
    """The reference's block sizes as it clips them, and its KV steps."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, {block_k}")
    bq, bk = min(block_q, s), min(block_k, t)
    return bq, bk, math.ceil(t / bk)


def _check_shapes(q, k, v, batched: bool):
    nd = 4 if batched else 2
    if q.ndim != nd or k.ndim != nd or v.ndim != nd:
        raise ValueError(f"expected {nd}-D q, k, v, got {q.ndim}, {k.ndim}, {v.ndim}")
    if k.shape != v.shape or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[-2] == 0:
        raise ValueError("attention needs at least one key")


def _no_key_rows(v: torch.Tensor, s: int, block_q: int, block_k: int) -> torch.Tensor:
    """The reference kernel's output for causal query rows ``0 .. S-T-1``
    (no valid key): ``sum(v[:min(L, T)]) / L`` in fp32, ``L`` the keys of
    the panels the row's query block visits. v: [..., T, D] -> [..., S-T, D]."""
    t = v.shape[-2]
    bq, bk, kv_steps = _ref_blocks(s, t, block_q, block_k)
    rows = torch.arange(s - t, device=v.device)
    lim = (rows // bq + 1) * bq - 1 + (t - s)
    n_live = torch.where(lim < 0, 0, torch.clamp(lim.clamp(min=0) // bk + 1, max=kv_steps))
    n_keys = n_live * bk
    csum = torch.cat([torch.zeros_like(v[..., :1, :], dtype=torch.float32),
                      v.float().cumsum(-2)], dim=-2)
    summed = csum[..., torch.clamp(n_keys, max=t), :]
    return summed / n_keys.clamp(min=1).to(torch.float32)[:, None]


def opope_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Plain PyTorch K3: q [..., S, D], k/v [..., T, D] -> [..., S, D] in
    ``q.dtype``. fp32 scores (TF32 off) scaled by ``D**-0.5``, masks with
    ``NEG_INF``, fp32 softmax, fp32 P·V over ``max(l, 1e-37)``; causal rows
    with no valid key by the closed form. P is cast to ``v.dtype`` where
    the reference casts it: the keys of each of its KV panels (``block_k``
    keys) at the running maximum through that panel, then rescaled to the
    final maximum in fp32."""
    if k.shape[-2] == 0:
        raise ValueError("attention needs at least one key")
    s, d = q.shape[-2:]
    t = k.shape[-2]
    _, bk, n_panels = _ref_blocks(s, t, block_q, block_k)
    with full_fp32():
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        scores = scores.masked_fill(~mask, NEG_INF)
    # [..., S, panel, key]: padded keys score NEG_INF and weigh 0
    panels = torch.nn.functional.pad(scores, (0, n_panels * bk - t),
                                     value=NEG_INF).unflatten(-1, (n_panels, bk))
    run = panels.amax(-1).cummax(-1).values  # the running maximum after each panel
    p = torch.exp(panels - run[..., None])
    w = torch.exp(run - run[..., -1:])[..., None]  # each panel's rescale to the final maximum
    l = (p * w).sum((-2, -1))[..., None]
    pv = (cast_out(p, v.dtype).float() * w).flatten(-2)[..., :t]
    with full_fp32():
        out = torch.matmul(pv, v.float()) / l.clamp(min=1e-37)
    if causal and s > t:
        out[..., : s - t, :] = _no_key_rows(v, s, block_q, block_k)
    return cast_out(out, q.dtype)


def _launch(q, k, v, causal: bool, block_q: int, block_k: int,
            route: Optional[str] = None) -> torch.Tensor:
    """One K3 launch over q [B, H, S, D], k/v [B, H, T, D] on the card, on
    :func:`_plan`'s route. ``route`` forces one (``"tile"`` takes every
    operand the kernels take; ``"sm90"`` raises where the plan is not
    sm90), so a caller can time the two routes on the same call."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"opope_attention runs on cuda tensors, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"opope_attention takes one dtype of {tuple(_DTYPE_CODES)} for q, k "
                         f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, d = q.shape
    t = k.shape[2]
    if d < 1:
        raise ValueError(f"opope_attention takes head dims of 1 or more, got {d}")
    if route not in (None, "sm90", "tile"):
        raise ValueError(f"unknown route {route!r}")
    ref_bq, ref_bk, ref_steps = _ref_blocks(s, t, block_q, block_k)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = _plan(q.shape, t, q.dtype, causal, (q.stride(), k.stride(), v.stride()),
                 (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    if route == "sm90" and plan.route != "sm90":
        raise ValueError(f"the sm90 route does not take this call ({plan})")
    route = route or plan.route
    vec = (0, 0, 0)
    if route == "tile":
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
        vec = tuple(_tile_vector(x) for x in (q, k, v))
    prm = _Params(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_int64 * 3)(*q.stride()[:3]), (ctypes.c_int64 * 3)(*k.stride()[:3]),
        (ctypes.c_int64 * 3)(*v.stride()[:3]), (ctypes.c_int64 * 3)(*out.stride()[:3]),
        b * h, h, s, t, d, _DTYPE_CODES[q.dtype], int(causal), ref_bq, ref_bk, ref_steps,
        (ctypes.c_int * 3)(*vec), d ** -0.5,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            maps = _Maps()
            for i, (dims, strides) in enumerate(plan.maps):
                maps.dims[i][:] = dims
                maps.strides[i][:] = strides
            rc = _launcher("sm90")(ctypes.byref(prm), ctypes.byref(maps), stream)
        else:
            rc = _launcher("tile")(ctypes.byref(prm), stream)
    if rc != 0:
        raise RuntimeError(f"opope_attention {route} kernel launch failed: error {rc}")
    opope_attention.launches += 1
    opope_attention.launches_by_route[route] += 1
    return out


def _tile_vector(x: torch.Tensor) -> bool:
    """Whether the tile route may read ``x``'s rows (unit stride along D)
    in whole vectors: 16 bytes of the compute type (fp16 for the 8-bit
    floats), ``vec`` elements of x's dtype, every stride but D's a multiple
    of it and the base aligned to its width in bytes. The kernel then moves
    an operand already in the compute type by cp.async, and widens the
    others a vector a load."""
    vec = 8 if x.dtype in FP8_DTYPES else 16 // x.element_size()
    return (all(st % vec == 0 for st in x.stride()[:-1])
            and x.data_ptr() % (vec * x.element_size()) == 0)


def opope_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Single-head attention on the hand-written kernel: q [S, D], k/v
    [T, D] -> [S, D] in ``q.dtype``. ``block_q``/``block_k`` are the
    reference's block sizes; they matter only for causal rows with no
    valid key (module docstring)."""
    _check_shapes(q, k, v, batched=False)
    if q.device.type == "cpu":
        return opope_attention_plain(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    return _launch(q[None, None], k[None, None], v[None, None], causal, block_q, block_k)[0, 0]


def opope_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Batched multi-head attention in one launch: q [B, H, S, D], k/v
    [B, H, T, D] -> [B, H, S, D] in ``q.dtype``, each (b, h) the
    single-head function of :func:`opope_attention`. Strided views (such as
    ``x.transpose(1, 2)`` of a [B, S, H, D] tensor) are read in place."""
    _check_shapes(q, k, v, batched=True)
    if q.device.type == "cpu":
        return opope_attention_plain(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    return _launch(q, k, v, causal, block_q, block_k)


opope_attention.launches = 0
opope_attention.launches_by_route = {"sm90": 0, "tile": 0}
