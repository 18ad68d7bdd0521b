"""State-resident linear scan (K6): the hand-written CUDA kernel and its
plain version.

Ports :func:`repro.kernels.opope_scan.opope_chunked_scan` (the Pallas TPU
kernel ``_scan_kernel``). Both functions compute every state of

    h[t] = decay[t] * h[t-1] + update[t],   h[-1] = 0,

over decay/update [S, D] (each fp32, bf16, fp16, e4m3 or e5m2, on its own;
widened exactly to fp32) into fp32 [S, D].
Each step rounds once, as a fused multiply-add: the reference gives that on
the CPU, where XLA contracts ``a[t] * h + b[t]`` in the interpret-mode
kernel and in its oracle alike. ``chunk`` is the reference's panel length;
the result does not depend on it.

* :func:`opope_chunked_scan` launches ``csrc/opope_scan.cu`` for tensors on
  the card and raises on what the kernel does not take. Given tensors on
  the CPU it runs :func:`opope_chunked_scan_plain`: the kernel has no CPU
  form. ``opope_chunked_scan.launches`` counts kernel launches.
* :func:`opope_chunked_scan_plain` loops over t with an exactly rounded
  fp32 FMA (:func:`.ref.fma_f32`): bitwise what ``__fmaf_rn`` gives on the
  card, so the kernel is held against it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build
from .ref import reference_chunked_scan

__all__ = ["opope_chunked_scan", "opope_chunked_scan_plain"]

# dtype codes shared with csrc/opope_scan.cu (K1's codes, csrc/opope_tile.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}


def _launcher():
    lib = _build.load("opope_scan")
    fn = lib.opope_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(decay: torch.Tensor, update: torch.Tensor, chunk: int) -> None:
    if decay.ndim != 2 or decay.shape != update.shape:
        raise ValueError(f"decay/update must both be [S, D], got {tuple(decay.shape)}, "
                         f"{tuple(update.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def opope_chunked_scan_plain(
    decay: torch.Tensor, update: torch.Tensor, *, chunk: int = 64
) -> torch.Tensor:
    """Plain PyTorch K6: every state of the scan in fp32, one rounding per
    step (bitwise the card's ``__fmaf_rn``). decay/update [S, D]."""
    _check(decay, update, chunk)
    return reference_chunked_scan(decay, update)


def opope_chunked_scan(
    decay: torch.Tensor, update: torch.Tensor, *, chunk: int = 64
) -> torch.Tensor:
    """All-states linear scan on the hand-written kernel: decay/update
    [S, D], each fp32, bf16, fp16, e4m3 or e5m2 -> states [S, D] fp32."""
    _check(decay, update, chunk)
    if decay.device.type == "cpu" and update.device.type == "cpu":
        return opope_chunked_scan_plain(decay, update, chunk=chunk)
    if decay.device.type != "cuda" or update.device != decay.device:
        raise ValueError(f"opope_chunked_scan runs on cuda tensors, got {decay.device}, "
                         f"{update.device}")
    if decay.dtype not in _DTYPE_CODES or update.dtype not in _DTYPE_CODES:
        raise ValueError(f"opope_chunked_scan takes {tuple(_DTYPE_CODES)}, got {decay.dtype}, "
                         f"{update.dtype}")
    s, d = decay.shape
    decay, update = decay.contiguous(), update.contiguous()
    out = torch.empty((s, d), dtype=torch.float32, device=decay.device)
    if out.numel() == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(decay.device):
        stream = torch.cuda.current_stream(decay.device).cuda_stream
        rc = launch(decay.data_ptr(), update.data_ptr(), out.data_ptr(), s, d,
                    _DTYPE_CODES[decay.dtype], _DTYPE_CODES[update.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"opope_chunked_scan kernel launch failed: CUDA error {rc}")
    opope_chunked_scan.launches += 1
    return out


opope_chunked_scan.launches = 0
