"""Model API of the port: init, prefill and decode entry points.

The port of :mod:`repro.models.api`, dispatched on ``cfg.family``. Batch
dicts (:func:`input_specs` owns the layout):

* token-prompt LM families (dense, moe): ``{"tokens", "labels"}``
* vlm: ``{"tokens", "labels", "patch_embeds"}``
* audio: ``{"frames", "tokens", "labels"}``

Decode state is a list with one entry per layer: a :class:`KVCache` (or,
in a quantized slot pool, :class:`~repro_torch.quant.kvcache.QuantKVCache`)
for an attention layer, a recurrent mixer's state
(:class:`~repro_torch.models.mamba.MambaState`,
:class:`~repro_torch.models.xlstm.MLSTMState`,
:class:`~repro_torch.models.xlstm.SLSTMState`) for the others; the audio
family's is an :class:`~repro_torch.models.encdec.EncDecCaches`.
``init_params`` and ``init_state`` run on ``cuda`` unless the caller passes
``device="cpu"``; the other entry points run where their tensors are. Their
``backend=`` is a backend name of :mod:`repro_torch.kernels.ops` or a
precision policy (:class:`repro_torch.quant.PrecisionPolicy`), resolved per
layer role. :func:`loss_fn` is the training loss.

Unlike the reference, no entry point clamps a cache write: :func:`prefill`
and :func:`decode` raise ``ValueError`` when the cache cannot hold the
prompt (with a vlm's image rows) or the next position.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.quant.kvcache import QuantKVCache
from repro_torch.tree import leaves
from . import encdec as encdec_mod
from . import transformer as tf_mod
from . import vlm as vlm_mod
from .attention import KVCache

__all__ = [
    "resolve_device",
    "init_params",
    "input_specs",
    "takes_token_prompt",
    "init_state",
    "loss_fn",
    "prefill",
    "decode",
    "prefill_bucketed",
    "prefill_chunk",
    "decode_at",
    "param_count",
    "active_param_count",
]


def resolve_device(device=None) -> torch.device:
    """``device`` or, by default, ``cuda``. A CUDA device on a machine
    without one raises; nothing quietly moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def init_params(
    cfg: ArchConfig, generator: Optional[torch.Generator] = None, device=None
) -> Dict[str, Any]:
    """Random parameters on ``device`` (default ``cuda``) in
    ``cfg.param_dtype``, drawn from ``generator`` (a generator on that
    device; seed 0 when omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _init_params(cfg, generator, dev)


def _init_params(cfg: ArchConfig, generator, device: torch.device) -> Dict[str, Any]:
    if cfg.family == "audio":
        return encdec_mod.init_encdec_params(cfg, generator, device)
    if cfg.family == "vlm":
        return vlm_mod.init_vlm_params(cfg, generator, device)
    return tf_mod.init_lm_params(cfg, generator, device)


def input_specs(cfg: ArchConfig, *, batch: int, seq: int, kind: str = "train",
                device="meta") -> Dict[str, torch.Tensor]:
    """Empty tensors on ``device`` (by default ``meta``: nothing allocated)
    for every model input of one cell, in the reference's layout, shapes and
    dtypes: int32 ``tokens`` (and ``labels`` for ``kind="train"``) of
    ``seq`` positions, less a vlm's image rows; bf16 ``patch_embeds``
    ``[batch, n_img_tokens, D]`` for vlm and ``frames`` ``[batch, enc_seq,
    D]`` for audio. ``kind="decode"`` is one new ``token`` [batch, 1]. The
    one owner of the batch layout (the shape harvest builds its batch
    here)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if kind not in ("train", "prefill"):
        return {"token": empty((batch, 1), torch.int32)}
    s_text = seq - cfg.n_img_tokens
    specs = {"tokens": empty((batch, s_text), torch.int32)}
    if kind == "train":
        specs["labels"] = empty((batch, s_text), torch.int32)
    if cfg.family == "vlm":
        specs["patch_embeds"] = empty((batch, cfg.n_img_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        specs["frames"] = empty((batch, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return specs


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Decode caches sized for ``max_len`` positions."""
    if cfg.family == "audio":
        return encdec_mod.init_decoder_caches(cfg, batch, max_len, dtype, resolve_device(device))
    return tf_mod.init_caches(cfg, batch, max_len, dtype, resolve_device(device))


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *, backend=None
            ) -> torch.Tensor:
    """Training loss of ``batch`` (:func:`input_specs`' layout) as a 0-d
    fp32 tensor."""
    if cfg.family == "audio":
        return encdec_mod.encdec_loss(params, batch["frames"], batch["tokens"],
                                      batch["labels"], cfg, backend=backend)
    if cfg.family == "vlm":
        return vlm_mod.vlm_loss(params, batch["tokens"], batch["patch_embeds"],
                                batch["labels"], cfg, backend=backend)
    return tf_mod.lm_loss(params, batch["tokens"], batch["labels"], cfg, backend=backend)


def _check_room(need: int, max_len: int, what: str) -> None:
    if need > max_len:
        raise ValueError(f"{what} needs {need} cache positions, the cache holds {max_len}")


def prefill(
    cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], max_len: int,
    cache_dtype=torch.bfloat16, *, backend=None,
):
    """Process the full prompt; return (last-token logits [B, V], caches).

    A vlm's image is projected on the default backend, not on ``backend``,
    as the reference's prefill does; its rows come first in the cache, so
    ``max_len`` counts ``n_img_tokens`` plus the prompt. An audio batch's
    ``frames`` run through the encoder, and the decoder's prefill carries
    every layer's cross K/V in the returned caches."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.family == "audio":
        _check_room(s, max_len, f"{cfg.name}'s prompt")
        enc_out = encdec_mod.encode(params, batch["frames"], cfg, backend=backend)
        caches = encdec_mod.init_decoder_caches(cfg, b, max_len, cache_dtype, tokens.device,
                                                cross=False)
        hidden, caches = encdec_mod.decoder_forward(
            params, tokens, cfg, enc_out=enc_out, caches=caches, mode="prefill",
            backend=backend)
        return tf_mod.lm_logits(params, hidden[:, -1:], cfg)[:, 0], caches
    extra = None
    if cfg.family == "vlm":
        _check_room(cfg.n_img_tokens + s, max_len, f"{cfg.name}'s image rows and prompt")
        extra = vlm_mod.project_image(params, batch["patch_embeds"])
    else:
        _check_room(s, max_len, f"{cfg.name}'s prompt")
    caches = tf_mod.init_caches(cfg, b, max_len, cache_dtype, tokens.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, tokens, cfg, mode="prefill", caches=caches, extra_embeds=extra,
        backend=backend,
    )
    return tf_mod.lm_logits(params, hidden[:, -1:], cfg)[:, 0], caches


def decode(
    cfg: ArchConfig, params, token: torch.Tensor, caches, pos, *, backend=None,
):
    """One lockstep decode step at position ``pos`` (an int; a vlm's counts
    its image rows). token: [B, 1] -> (logits [B, V], caches). The token's
    K/V go to the KV caches' fill point, which must lie inside them; a
    recurrent layer's state takes the token whatever ``pos`` is."""
    kv = [c for c in (caches.self_kv if cfg.family == "audio" else caches)
          if isinstance(c, (KVCache, QuantKVCache))]
    if kv and isinstance(kv[0].length, int):
        _check_room(kv[0].length + 1, kv[0].k.shape[1], f"{cfg.name}'s decode step")
    if cfg.family == "audio":
        hidden, caches = encdec_mod.decoder_forward(
            params, token, cfg, caches=caches, mode="decode", backend=backend)
        return tf_mod.lm_logits(params, hidden, cfg)[:, 0], caches
    b = token.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int64, device=token.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, token, cfg, mode="decode", caches=caches, positions=positions,
        backend=backend,
    )
    return tf_mod.lm_logits(params, hidden, cfg)[:, 0], caches


def prefill_bucketed(
    cfg: ArchConfig, params, tokens: torch.Tensor, lengths: torch.Tensor,
    cache_dtype=torch.bfloat16, *, backend=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """Prefill a right-padded prompt bucket: tokens [B, Lb], lengths [B].
    Causal attention hides the pad from every real token, so the logits read
    at each row's ``lengths[b] - 1`` are the unpadded prefill logits. Pad
    flows through a recurrent state, so the scheduler gives patterns with
    recurrent mixers exact-length buckets. Token-prompt LM families only:
    vlm and audio raise."""
    _token_prompt_only(cfg, "bucketed prefill")
    b, lb = tokens.shape
    caches = tf_mod.init_caches(cfg, b, lb, cache_dtype, tokens.device)
    hidden, caches, _ = tf_mod.lm_forward(
        params, tokens, cfg, mode="prefill", caches=caches, backend=backend
    )
    rows = torch.arange(b, device=tokens.device)
    last = hidden[rows, lengths.to(torch.int64) - 1]
    return tf_mod.lm_logits(params, last[:, None], cfg)[:, 0], caches


def prefill_chunk(
    cfg: ArchConfig, params, tokens: torch.Tensor, caches: List[Any],
    offsets: torch.Tensor, last_idx: torch.Tensor, *, backend=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """Advance a prompt-chunk window: tokens [B, C] written at per-row
    ``offsets[b]``; returns (logits [B, V], caches).

    Row ``b``'s chunk takes absolute positions ``offsets[b] ..
    offsets[b] + C - 1`` of its cache, which may start past 0 (earlier
    chunks, or a cached prefix attached below ``offsets[b]``). ``offsets``
    is the source of truth for the fill point, as ``pos`` is for
    :func:`decode_at`. A row with nothing left to prefill passes an offset
    ``>= S_max``: its writes drop and its logits are not read. Logits are
    read at chunk index ``last_idx[b]`` (the row's last prompt token when
    this chunk finishes it; callers mask the others). Token-prompt LM
    families with attention-only patterns: vlm and audio raise, and a
    recurrent mixer raises inside the forward."""
    _token_prompt_only(cfg, "chunked prefill")
    b, c = tokens.shape
    offsets = offsets.to(torch.int64)
    positions = offsets[:, None] + torch.arange(c, device=tokens.device)[None, :]
    caches = _with_slot_lengths(caches, offsets)
    hidden, caches, _ = tf_mod.lm_forward(
        params, tokens, cfg, mode="chunk", caches=caches, positions=positions,
        backend=backend,
    )
    rows = torch.arange(b, device=tokens.device)
    last = hidden[rows, last_idx.to(torch.int64)]
    return tf_mod.lm_logits(params, last[:, None], cfg)[:, 0], caches


def decode_at(
    cfg: ArchConfig, params, token: torch.Tensor, caches: List[Any],
    pos: torch.Tensor, *, backend=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """Slot-indexed decode step: row ``b`` appends at ``pos[b]`` and attends
    over its own history. ``pos`` [B] is the source of truth for every
    layer's fill point. The audio family raises."""
    if cfg.family == "audio":
        raise NotImplementedError("slot-indexed decode: decoder-only LM families only")
    pos = pos.to(torch.int64)
    caches = _with_slot_lengths(caches, pos)
    hidden, caches, _ = tf_mod.lm_forward(
        params, token, cfg, mode="decode", caches=caches, positions=pos[:, None],
        backend=backend,
    )
    return tf_mod.lm_logits(params, hidden, cfg)[:, 0], caches


def takes_token_prompt(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s model reads a token prompt alone. A vlm's image rows
    and an audio model's frames do not fit a token-prompt request: those
    families are served by the static ``ServeEngine`` only, and neither the
    slot-indexed entry points nor the train launcher take them."""
    return cfg.family not in ("audio", "vlm")


def _token_prompt_only(cfg: ArchConfig, what: str) -> None:
    if not takes_token_prompt(cfg):
        raise NotImplementedError(f"{what}: token-prompt LM families only, not {cfg.family}")


def _with_slot_lengths(caches, pos: torch.Tensor):
    """Every KV cache (full-precision or quantized, scales kept) with its
    fill point set to the per-slot positions ``pos``; recurrent states
    untouched."""
    return [dataclasses.replace(c, length=pos) if isinstance(c, (KVCache, QuantKVCache)) else c
            for c in caches]


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted from shapes alone (on the meta
    device, nothing is allocated)."""
    params = _init_params(cfg, None, torch.device("meta"))
    return sum(x.numel() for x in leaves(params))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters one token runs through: the routed experts count
    ``top_k`` of ``n_experts``."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    expert_params_per_layer = 3 * cfg.d_model * cfg.moe.d_ff_expert
    n_moe_layers = cfg.n_periods * sum(1 for b in cfg.pattern if b.ffn == "moe")
    routed_total = n_moe_layers * cfg.moe.n_experts * expert_params_per_layer
    routed_active = n_moe_layers * cfg.moe.top_k * expert_params_per_layer
    return total - routed_total + routed_active
