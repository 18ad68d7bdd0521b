"""Lockstep batched serving: prefill, then greedy or sampled decode.

The port of :mod:`repro.serve.engine`. PyTorch runs eagerly, so each step is
a sequence of launches rather than one compiled program. Each step is
dispatched through :class:`repro_torch.obs.attr.StepKeys`, whose step
scope is the analogue of the reference's ``jit`` trace: the prefill per prompt shape and the decode step
per batch size count their GEMMs into ``gemm.calls`` on their first
dispatch only.

The batch dict carries a vlm's ``patch_embeds`` or an audio model's
``frames`` into the prefill beside ``tokens``. A vlm decodes from its true
position, ``n_img_tokens + prompt_len``, where the reference's engine starts
at ``prompt_len``; ``max_len`` counts every cache position, the image rows
included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.obs import attr as _attr

__all__ = ["ServeEngine", "sample_token"]


def sample_token(
    logits: torch.Tensor, generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
) -> torch.Tensor:
    """logits [B, V] -> [B, 1] int64 token. Greedy at temperature 0 (argmax,
    first index on ties); otherwise a draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


@dataclasses.dataclass
class ServeEngine:
    cfg: ArchConfig
    params: Any
    max_len: int
    cache_dtype: torch.dtype = torch.bfloat16
    temperature: float = 0.0

    def __post_init__(self) -> None:
        self._steps = _attr.StepKeys()  # step keys dispatched so far

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        n_tokens: int,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Prefill the prompt batch (with its non-token input, if the family
        has one) and decode ``n_tokens``; returns the generated tokens
        [B, n_tokens]."""
        cfg, params = self.cfg, self.params
        with self._steps.dispatch(("prefill", tuple(batch["tokens"].shape))):
            logits, caches = model_api.prefill(
                cfg, params, batch, self.max_len, self.cache_dtype
            )
        tok = sample_token(logits, generator, self.temperature)
        pos = cfg.n_img_tokens + batch["tokens"].shape[1]
        out = [tok]
        for i in range(n_tokens - 1):
            with self._steps.dispatch(("decode", tok.shape[0])):
                logits, caches = model_api.decode(cfg, params, tok, caches, pos + i)
            tok = sample_token(logits, generator, self.temperature)
            out.append(tok)
        return torch.cat(out, dim=1)
