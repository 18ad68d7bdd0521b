"""O-POPE GEMM: the hand-written CUDA kernel and its plain PyTorch version.

Ports :func:`repro.kernels.opope_gemm.opope_gemm` (the Pallas TPU kernel).
Both functions here compute ``O = epilogue(A[M,K] @ B[K,N] (+ C))`` with an
fp32 accumulator, ``C`` a full ``[M, N]`` tile or an ``[N]`` bias row
preloaded into it, the epilogue chain run on the fp32 accumulator, and one
cast to ``out_dtype`` at the end.

* :func:`opope_gemm` launches ``csrc/opope_gemm.cu`` for tensors on the card
  (design notes are in that file) and raises on what the kernel does not
  take. Given tensors on the CPU it runs :func:`opope_gemm_plain`: the kernel
  has no CPU form. ``opope_gemm.launches`` counts kernel launches.
* :func:`opope_gemm_plain` is ``a.float() @ b.float()`` (TF32 off) plus C,
  the same epilogue chain, one cast: the CPU path and the reference the
  kernel is held against on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional, Tuple

import torch

from . import build as _build
from . import epilogue as _ep

__all__ = ["opope_gemm", "opope_gemm_plain", "full_fp32", "MAX_EPILOGUE_STEPS"]

MAX_EPILOGUE_STEPS = 8

# dtype codes shared with csrc/opope_tile.cuh
_DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int8: 3,
}
_IN_DTYPES = (torch.float32, torch.bfloat16)
_OPERAND_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class _Epilogue(ctypes.Structure):
    """Mirror of ``struct OpopeEpilogue`` in csrc/opope_tile.cuh."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("op", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("kind", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("dtype", ctypes.c_int * MAX_EPILOGUE_STEPS),
        ("ptr", ctypes.c_void_p * MAX_EPILOGUE_STEPS),
    ]


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """fp32 products on the card in full fp32, never TF32, inside the block
    (the plain versions and the model's fp32 einsums run in it)."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def _launcher():
    lib = _build.load("opope_gemm")
    fn = lib.opope_gemm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, i, i, i, i, i,
                       ctypes.POINTER(_Epilogue), p]
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, n = a.shape[0], b.shape[1]
    if c is not None and tuple(c.shape) not in ((n,), (m, n)):
        raise ValueError(f"C preload shape {tuple(c.shape)} != {(n,)} or {(m, n)}")
    if out_dtype == torch.int8 and (not epilogue or epilogue[-1] != "requant_int8"):
        raise ValueError("int8 output needs an epilogue chain ending in requant_int8")
    n_ops = sum(1 for s in epilogue if _ep.op_kind(s) != "none")
    if n_ops != len(epilogue_operands):
        raise ValueError(
            f"epilogue {epilogue} takes {n_ops} operands, got {len(epilogue_operands)}"
        )
    return m, n


def _check_launch_operands(fn, a, b, c, out_dtype, epilogue, epilogue_operands):
    """What a kernel launch takes: bf16 or fp32 inputs of one dtype, a known
    out dtype, at most 8 epilogue steps, contiguous operands on one device."""
    if a.dtype not in _IN_DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"{fn} takes bf16 or fp32 inputs of one dtype, got {a.dtype} @ {b.dtype}"
        )
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if len(epilogue) > MAX_EPILOGUE_STEPS:
        raise ValueError(f"at most {MAX_EPILOGUE_STEPS} epilogue steps, got {len(epilogue)}")
    tensors = [a, b] + ([c] if c is not None else []) + list(epilogue_operands)
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"operand on {t.device}, GEMM on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} takes contiguous operands")
    for t in tensors[2:]:
        if t.dtype not in _OPERAND_DTYPES:
            raise TypeError(f"unsupported C/epilogue operand dtype {t.dtype}")


def _epilogue_struct(epilogue, epilogue_operands, shapes) -> _Epilogue:
    """The chain as the kernels' by-value struct; ``shapes`` maps each
    operand kind to the canonical shape its operand must have."""
    ep = _Epilogue()
    ep.n_steps = len(epilogue)
    it = iter(epilogue_operands)
    for s, name in enumerate(epilogue):
        op = _ep.op_def(name)
        ep.op[s] = op.code
        ep.kind[s] = _ep.KIND_CODES[op.kind]
        if op.kind != "none":
            x = next(it)
            want = shapes[op.kind]
            if tuple(x.shape) != want:
                raise ValueError(f"epilogue {name!r} operand {tuple(x.shape)} != {want}")
            ep.dtype[s] = _DTYPE_CODES[x.dtype]
            ep.ptr[s] = x.data_ptr()
    return ep


def opope_gemm_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """Plain PyTorch ``epilogue(A @ B (+ C))``: fp32 product (TF32 off),
    C added in fp32, the epilogue chain in fp32, one cast."""
    out_dtype = out_dtype or a.dtype
    _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    with full_fp32():
        acc = a.float() @ b.float()
    if c is not None:
        acc = acc + c.float()
    acc = _ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
    return acc.to(out_dtype)


def opope_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    c: Optional[torch.Tensor] = None,
    *,
    out_dtype: Optional[torch.dtype] = None,
    epilogue: Tuple[str, ...] = (),
    epilogue_operands: Tuple[torch.Tensor, ...] = (),
) -> torch.Tensor:
    """``O = epilogue(A @ B (+ C))`` on the hand-written CUDA kernel.

    a: [M, K], b: [K, N], both bf16 or both fp32, contiguous. c: [M, N] or
    [N]. ``epilogue`` names up to 8 registered steps; ``epilogue_operands``
    carries one canonical operand per operand-taking step (scalar ``(1,1)``,
    row ``(1,N)``, full ``(M,N)``). ``out_dtype`` is bf16, fp16 or fp32, or
    int8 behind ``requant_int8``; it defaults to ``a.dtype``.
    """
    if a.device.type == "cpu":
        return opope_gemm_plain(
            a, b, c, out_dtype=out_dtype, epilogue=epilogue,
            epilogue_operands=epilogue_operands,
        )
    if a.device.type != "cuda":
        raise ValueError(f"opope_gemm runs on cuda tensors, got {a.device}")
    out_dtype = out_dtype or a.dtype
    m, n = _check_shapes(a, b, c, out_dtype, epilogue, epilogue_operands)
    k = a.shape[1]
    _check_launch_operands("opope_gemm", a, b, c, out_dtype, epilogue, epilogue_operands)
    ep = _epilogue_struct(epilogue, epilogue_operands,
                          {"scalar": (1, 1), "row": (1, n), "full": (m, n)})

    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    vec = 16 // a.element_size()
    vec_a = k % vec == 0 and a.data_ptr() % 16 == 0
    vec_b = n % vec == 0 and b.data_ptr() % 16 == 0
    c_kind = 0 if c is None else (2 if c.ndim == 1 else 3)
    launch = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPE_CODES[a.dtype],
            None if c is None else c.data_ptr(), c_kind,
            0 if c is None else _DTYPE_CODES[c.dtype],
            _DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
            ctypes.byref(ep), stream,
        )
    if rc != 0:
        raise RuntimeError(f"opope_gemm kernel launch failed: CUDA error {rc}")
    opope_gemm.launches += 1
    return out


opope_gemm.launches = 0
