"""LLaVA-NeXT-style VLM on the port (mistral-7b backbone).

The port of :mod:`repro.models.vlm`. The anyres vision tower is a stub, as
in the reference: the caller supplies precomputed patch embeddings
``[B, n_img_tokens, D]`` (:func:`repro_torch.models.api.input_specs`). The
multimodal projector, a 2-layer MLP, is real; its output is prepended to
the token embeddings and the decoder-only backbone of
:mod:`.transformer` runs over the combined sequence. The loss covers the
text positions only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from .layers import Initializer
from .transformer import _chunked_ce, init_lm_params, lm_forward, param_dtype

__all__ = ["init_vlm_params", "project_image", "vlm_forward", "vlm_loss"]


def init_vlm_params(
    cfg: ArchConfig, generator: Optional[torch.Generator], device: torch.device
) -> Dict[str, Any]:
    """The backbone's parameters plus ``mm_projector`` (``w1``, ``w2``, both
    ``[D, D]`` at ``fan_in=D``), drawn on ``device`` in ``cfg.param_dtype``."""
    params = init_lm_params(cfg, generator, device)
    init = Initializer(dtype=param_dtype(cfg), device=device, generator=generator)
    d = cfg.d_model
    params["mm_projector"] = {"w1": init((d, d), fan_in=d), "w2": init((d, d), fan_in=d)}
    return params


def project_image(params, patch_embeds: torch.Tensor, *, backend=None) -> torch.Tensor:
    """The 2-layer GELU projector from vision space into the LM's embedding
    space: two GEMMs, the GELU (tanh-approximate) riding the first one's
    epilogue."""
    h = ops.matmul(patch_embeds, params["mm_projector"]["w1"], backend=backend,
                   epilogue=["gelu"])
    return ops.matmul(h, params["mm_projector"]["w2"], backend=backend)


def vlm_forward(
    params,
    tokens: torch.Tensor,
    patch_embeds: torch.Tensor,
    cfg: ArchConfig,
    *,
    mode: str = "train",
    caches=None,
    backend=None,
):
    """The backbone over the projected image rows and the tokens:
    :func:`~.transformer.lm_forward`'s ``(hidden, caches, aux)``."""
    img = project_image(params, patch_embeds, backend=backend)
    return lm_forward(params, tokens, cfg, mode=mode, caches=caches, extra_embeds=img,
                      backend=backend)


def vlm_loss(
    params,
    tokens: torch.Tensor,
    patch_embeds: torch.Tensor,
    labels: torch.Tensor,
    cfg: ArchConfig,
    *,
    backend=None,
) -> torch.Tensor:
    """Cross-entropy over the text positions only (the image rows are
    context), plus ``0.01`` times the MoE load-balancing loss."""
    hidden, _, aux = vlm_forward(params, tokens, patch_embeds, cfg, mode="train",
                                 backend=backend)
    hidden = hidden[:, cfg.n_img_tokens:]
    return _chunked_ce(params, hidden, labels, cfg) + 0.01 * aux
