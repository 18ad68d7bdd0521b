"""Workload harvesting: which GEMM shapes does a model actually run?

The port of :mod:`repro.tune.capture`. Tuning a deployment offline needs
the exact (M, K, N, G, dtype) set its layers push through the registry.
:func:`repro_torch.kernels.ops.capture_shapes` records every ``matmul`` /
``grouped_matmul`` and, while active, computes nothing (each call returns
an empty result of the right shape and dtype on its operands' device). So
one training forward of a ``configs/`` model with its parameters and inputs
on ``torch.device("meta")`` — the port's ``jax.eval_shape`` — yields the
model's whole GEMM workload with zero FLOPs and no parameter memory.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .table import GemmShape

__all__ = ["capture_gemm_shapes", "harvest_model_shapes"]


class capture_gemm_shapes:
    """Context manager yielding the deduped list of :class:`GemmShape` routed
    through the registry inside the block (first-seen order)."""

    def __enter__(self) -> List[GemmShape]:
        from repro_torch.kernels import ops

        self._cm = ops.capture_shapes()
        self._raw = self._cm.__enter__()
        self._out: List[GemmShape] = []
        return self._out

    def __exit__(self, *exc) -> bool:
        self._cm.__exit__(*exc)
        seen = set()
        for family, m, k, n, g, dtype in self._raw:
            shape = GemmShape(family=family, m=m, k=k, n=n, g=g, dtype=dtype)
            if shape not in seen:
                seen.add(shape)
                self._out.append(shape)
        return False


def harvest_model_shapes(
    arch: Union[str, object],
    *,
    batch: int = 1,
    seq: int = 128,
    backend: Optional[object] = None,
) -> List[GemmShape]:
    """Every distinct GEMM shape one training step of ``arch`` runs.

    ``arch`` is a ``configs/`` name or an ``ArchConfig``. ``backend`` is
    threaded through so a :class:`~repro_torch.quant.policy.PrecisionPolicy`
    (or a q8 backend name) captures the quantized routing it would really
    use. Parameters and the batch (:func:`~repro_torch.models.api.input_specs`,
    so a vlm's projector and an audio model's encoder are harvested too)
    live on the meta device: nothing is materialized and nothing runs.
    """
    from repro_torch.models import api as model_api

    if isinstance(arch, str):
        from repro_torch.configs import get_config

        cfg = get_config(arch)
    else:
        cfg = arch
    meta = torch.device("meta")
    params = model_api.init_params(cfg, torch.Generator().manual_seed(0), meta)
    specs = model_api.input_specs(cfg, batch=batch, seq=seq, kind="train", device=meta)
    with capture_gemm_shapes() as shapes:
        model_api.loss_fn(cfg, params, specs, backend=backend)
    return shapes
