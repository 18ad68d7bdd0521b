"""Decoder-only LM assembly: a Python loop over layers.

The port of :mod:`repro.models.transformer` for the decoder-only
families: dense periods of ``("attn" | "attn_local", "mlp")`` blocks
(chatglm3-6b, qwen2.5-32b; stablelm-12b's parallel block; gemma2-9b's
``(attn_local, attn)`` period with its sliding window and soft-capping),
MoE periods of ``("attn", "moe")`` blocks (deepseek-moe-16b, grok-1-314b),
the hybrid period of jamba-v0.1-52b (``("mamba", "mlp" | "moe")`` and
``("attn", "mlp")`` blocks), the ssm period of xlstm-125m (``("slstm",
"none")`` and ``("mlstm", "none")`` blocks: no FFN), and the vlm family's
dense backbone (llava-next-mistral-7b), whose image rows come in as
``extra_embeds`` prepended to the token embeddings. Parameters are a dict;
``params["blocks"]`` is a list with one dict per layer, in place of the
reference's per-period stacks under ``lax.scan``: layer ``i`` is the block
``cfg.pattern[i % len(cfg.pattern)]``, periods one after another. Caches
are a list with one entry per layer: a :class:`KVCache` for an attention
layer, a :class:`~.mamba.MambaState`, :class:`~.xlstm.MLSTMState` or
:class:`~.xlstm.SLSTMState` for a recurrent one.

Modes: ``train`` (full sequence, no caches, positions ``0..S-1``; each
block under ``torch.utils.checkpoint`` when ``cfg.remat`` asks for the
``"full"`` policy, as the reference's ``jax.checkpoint`` of its layer-scan
body), ``prefill`` (full sequence, fills the caches; a recurrent layer
installs its state after the last token), ``chunk`` (a chunk of prompt
tokens written at per-row ``positions`` of the caches and attending over
each row's history; a recurrent layer raises ``NotImplementedError``, as
its state cannot resume mid-prompt) and ``decode`` (one token against the
caches). A recurrent layer with a cache and one token takes its decode
step, a one-token prefill included, as the reference's does. Without caches
a prefill returns hidden states only. ``lm_forward`` also returns the MoE
router's load-balancing loss, summed over layers, as the reference does.
:func:`lm_loss` is the training loss: the chunked cross-entropy of
:func:`_chunked_ce` plus ``0.01`` times that loss. The audio family is an
encoder-decoder (:mod:`.encdec`) and is refused here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.kernels.opope_gemm import full_fp32
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import xlstm as xlstm_mod
from .attention import KVCache
from .layers import (
    Initializer,
    embedding_init,
    layernorm,
    layernorm_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    role_backend,
    softcap,
)
from .moe import moe_apply, moe_init

__all__ = [
    "check_supported",
    "param_dtype",
    "init_lm_params",
    "init_caches",
    "lm_forward",
    "lm_logits",
    "lm_loss",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


# The (mixer, ffn) blocks each ported family may have in its period.
_PORTED_BLOCKS = {
    "dense": {("attn", "mlp"), ("attn_local", "mlp")},
    "moe": {("attn", "moe")},
    "hybrid": {("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")},
    "ssm": {("slstm", "none"), ("mlstm", "none")},
    "vlm": {("attn", "mlp")},
    "audio": {("attn", "mlp")},
}
_ATTENTION = ("attn", "attn_local")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a period the port does not run: a
    block outside its family's set, an MoE spec without MoE blocks (or
    the reverse), mamba blocks without a mamba spec, or a parallel block
    outside the dense family."""
    blocks = _PORTED_BLOCKS.get(cfg.family)
    has_moe = any(bd.ffn == "moe" for bd in cfg.pattern)
    if (blocks is None or (cfg.moe is not None) != has_moe
            or any((bd.mixer, bd.ffn) not in blocks for bd in cfg.pattern)
            or (cfg.mamba is None and any(bd.mixer == "mamba" for bd in cfg.pattern))):
        raise NotImplementedError(
            f"{cfg.name}: only dense ('attn' | 'attn_local', 'mlp'), MoE "
            f"('attn', 'moe'), hybrid ('mamba', 'mlp' | 'moe') + ('attn', 'mlp'), ssm "
            f"('slstm' | 'mlstm', 'none'), vlm and audio ('attn', 'mlp') periods are "
            f"ported; got family {cfg.family!r}, pattern {cfg.pattern}"
        )
    if cfg.parallel_block and cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: a parallel MoE block is not ported")


def _check_decoder_only(cfg: ArchConfig) -> None:
    check_supported(cfg)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: see repro_torch.models.encdec")


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _norm_init(cfg: ArchConfig, d: int, device):
    return rmsnorm_init(d, device) if cfg.norm == "rmsnorm" else layernorm_init(d, device)


def _norm(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def init_lm_params(
    cfg: ArchConfig, generator: Optional[torch.Generator], device: torch.device
) -> Dict[str, Any]:
    """Random parameters, drawn on ``device`` in ``cfg.param_dtype``."""
    _check_decoder_only(cfg)
    init = Initializer(dtype=param_dtype(cfg), device=device, generator=generator)
    params: Dict[str, Any] = {
        "embed": embedding_init(cfg.vocab, cfg.d_model, init),
        "final_norm": _norm_init(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((cfg.vocab, cfg.d_model))
    params["blocks"] = [_block_init(cfg, _block_def(cfg, layer), init, device)
                        for layer in range(cfg.n_layers)]
    return params


def _block_init(cfg: ArchConfig, bd: BlockDef, init: Initializer, device) -> Dict[str, Any]:
    """One layer's parameters: the mixer's under its name (``attn``,
    ``mamba``, ``mlstm`` or ``slstm``) after ``norm_mixer``, then, unless
    the block has no FFN, ``norm_ffn`` and the ``mlp`` or ``moe``."""
    block: Dict[str, Any] = {"norm_mixer": _norm_init(cfg, cfg.d_model, device)}
    if bd.mixer in _ATTENTION:
        block["attn"] = attn_mod.attention_init(
            cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_, init, qkv_bias=cfg.qkv_bias)
    elif bd.mixer == "mamba":
        m = cfg.mamba
        block["mamba"] = mamba_mod.mamba_init(cfg.d_model, init, expand=m.expand,
                                              d_state=m.d_state, d_conv=m.d_conv)
    elif bd.mixer == "mlstm":
        block["mlstm"] = xlstm_mod.mlstm_init(cfg.d_model, cfg.n_heads, init)
    else:
        block["slstm"] = xlstm_mod.slstm_init(cfg.d_model, cfg.n_heads, init)
    if bd.ffn != "none":
        block["norm_ffn"] = _norm_init(cfg, cfg.d_model, device)
    if bd.ffn == "mlp":
        block["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, init)
    elif bd.ffn == "moe":
        block["moe"] = moe_init(
            cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts, init,
            n_shared=cfg.moe.n_shared, d_ff_shared=cfg.moe.d_ff_shared,
        )
    return block


def _block_def(cfg: ArchConfig, layer: int) -> BlockDef:
    """The block of layer ``layer``: periods of ``cfg.pattern`` in order."""
    return cfg.pattern[layer % len(cfg.pattern)]


def _block_cache(cfg: ArchConfig, bd: BlockDef, batch: int, max_len: int, dtype, device):
    if bd.mixer in _ATTENTION:
        return KVCache.zeros(batch, max_len, cfg.n_kv, cfg.head_dim_, dtype, device)
    if bd.mixer == "mamba":
        m = cfg.mamba
        return mamba_mod.MambaState.zeros(batch, m.expand * cfg.d_model, m.d_state, m.d_conv,
                                          dtype, device)
    if bd.mixer == "mlstm":
        return xlstm_mod.MLSTMState.zeros(batch, cfg.n_heads, cfg.head_dim_, device)
    return xlstm_mod.SLSTMState.zeros(batch, cfg.n_heads, cfg.head_dim_, device)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype, device) -> List[Any]:
    """One zeroed cache per layer: a KV cache of ``max_len`` positions for
    an attention layer (a local layer's spans ``max_len`` too, as the
    reference's), the zero state of a recurrent one (its conv window in
    ``dtype``, the rest fp32)."""
    _check_decoder_only(cfg)
    return [_block_cache(cfg, _block_def(cfg, layer), batch, max_len, dtype, device)
            for layer in range(cfg.n_layers)]


def _block_apply(cfg: ArchConfig, bd: BlockDef, p, x, *, positions, cache, backend,
                 chunk=False):
    """One layer ``bd``. The mixer: attention (sliding-window for
    ``attn_local``) with its skip connection fused into the output
    projection, or a recurrent mixer (mamba, mLSTM, sLSTM; their GEMMs on
    the policy role ``mixer``) with a plain skip add. A recurrent mixer with
    a cache and one token takes its decode step; otherwise it runs over the
    sequence and, with a cache, installs its state after the last token.
    Then the pre-norm MLP with its skip fused into w_down, the pre-norm MoE
    with a plain skip add, or nothing (``ffn="none"``). A parallel block's
    MLP reads the attention's normed input and takes the attention's stream
    as its w_down residual; its ``norm_ffn`` is carried unused, as in the
    reference. Returns (x, new_cache, aux loss or None)."""
    h = _norm(cfg, p["norm_mixer"], x)
    if bd.mixer in _ATTENTION:
        stream, new_cache = attn_mod.attention_apply(
            p["attn"],
            h,
            n_heads=cfg.n_heads,
            n_kv=cfg.n_kv,
            head_dim=cfg.head_dim_,
            positions=positions,
            rotary_frac=cfg.rope_frac,
            rope_theta=cfg.rope_theta,
            window=cfg.window if bd.mixer == "attn_local" else None,
            attn_softcap=cfg.attn_softcap,
            cache=cache,
            q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk,
            backend=backend,
            residual=x,
            chunk=chunk,
        )
    else:
        if chunk:
            # A recurrent state cannot resume mid-prompt from a cache
            # scatter; the engine keeps chunked prefill to attention-only
            # patterns.
            raise NotImplementedError("chunked prefill requires attention mixers")
        mixer_out, new_cache = _recurrent_apply(cfg, bd.mixer, p[bd.mixer], h, cache,
                                                role_backend(backend, "mixer"))
        stream = x + mixer_out
    if bd.ffn == "none":
        return stream, new_cache, None
    if not cfg.parallel_block:
        h = _norm(cfg, p["norm_ffn"], stream)
    if bd.ffn == "mlp":
        return mlp_apply(p["mlp"], h, backend=backend, residual=stream), new_cache, None
    moe = cfg.moe
    y, aux = moe_apply(
        p["moe"], h, n_experts=moe.n_experts, top_k=moe.top_k,
        capacity_factor=moe.capacity_factor, dispatch=moe.dispatch,
        group_size=moe.group_size, dropless=moe.dropless, backend=backend,
    )
    # The MoE output is a weighted expert combine, not a bare GEMM
    # writeback, so its skip connection stays a plain add.
    return stream + y, new_cache, aux


# Each recurrent mixer's (full-sequence form, one-token step); mamba takes
# no head count, the sLSTM no chunk.
_RECURRENT = {
    "mamba": (mamba_mod.mamba_apply, mamba_mod.mamba_decode_step),
    "mlstm": (xlstm_mod.mlstm_apply, xlstm_mod.mlstm_decode_step),
    "slstm": (xlstm_mod.slstm_apply, xlstm_mod.slstm_decode_step),
}


def _recurrent_apply(cfg: ArchConfig, mixer: str, p, h, cache, backend):
    """A mamba, mLSTM or sLSTM mixer on the normed input ``h``: (its output,
    the new state, or None without a cache)."""
    apply, step = _RECURRENT[mixer]
    heads = {} if mixer == "mamba" else {"n_heads": cfg.n_heads}
    if cache is not None and h.shape[1] == 1:
        return step(p, h, cache, backend=backend, **heads)
    chunk = {} if mixer == "slstm" else {"chunk": cfg.scan_chunk}
    if cache is None:
        return apply(p, h, backend=backend, **heads, **chunk), None
    return apply(p, h, backend=backend, return_state=True, **heads, **chunk)


def lm_forward(
    params,
    tokens: torch.Tensor,
    cfg: ArchConfig,
    *,
    mode: str = "prefill",
    caches: Optional[List[Any]] = None,
    positions: Optional[torch.Tensor] = None,
    extra_embeds: Optional[torch.Tensor] = None,
    backend=None,
) -> Tuple[torch.Tensor, Optional[List[Any]], torch.Tensor]:
    """Run the backbone. tokens: [B, S] -> (final-normed hidden [B, S', D],
    new caches or None, the MoE load-balancing loss summed over layers as a
    0-d fp32 tensor, zero without MoE layers). ``extra_embeds`` [B, n, D]
    (the vlm family's projected image) are cast to the embeddings' dtype and
    prepended, so S' = n + S and the default positions run over image and
    text rows alike. ``backend`` is a backend name or a precision policy;
    each GEMM site resolves its own role."""
    _check_decoder_only(cfg)
    if mode not in ("train", "prefill", "chunk", "decode"):
        raise ValueError(f"unknown lm_forward mode {mode!r}")
    if mode == "train" and caches is not None:
        raise ValueError("lm_forward mode 'train' takes no caches")
    remat = mode == "train" and cfg.remat and cfg.remat_policy != "none"
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported (no config uses it); "
            f"'full' and 'none' are"
        )
    chunk = mode == "chunk"  # chunked prefill: scatter-append at `positions`
    x = params["embed"]["table"][tokens]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    new_caches: Optional[List[Any]] = [] if caches is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(params["blocks"]):
        cache = caches[layer] if caches is not None else None
        bd = _block_def(cfg, layer)
        if remat:
            # Full remat: keep the block's input, recompute the rest in the
            # backward (its GEMMs run twice a step).
            x, nc, a = torch.utils.checkpoint.checkpoint(
                _block_apply, cfg, bd, p, x, positions=positions, cache=None,
                backend=backend, use_reentrant=False)
        else:
            x, nc, a = _block_apply(cfg, bd, p, x, positions=positions, cache=cache,
                                    backend=backend, chunk=chunk)
        if a is not None:
            aux = aux + a
        if new_caches is not None:
            new_caches.append(nc)
    return _norm(cfg, params["final_norm"], x), new_caches, aux


def lm_logits(params, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits [B, S, V] from fp32 products (TF32 off), as the reference's
    einsum with ``preferred_element_type=float32``."""
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    with full_fp32():
        logits = hidden.float() @ table.float().t()
    return softcap(logits, cfg.final_softcap)


def _chunked_ce(
    params, hidden: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig,
    loss_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean softmax cross-entropy over the (masked) tokens, computed
    ``cfg.loss_chunk`` positions at a time (the largest divisor of S not
    above it), so no [B, S, V] logits tensor is built at once. Logits are
    fp32 from fp32 products (TF32 off), as :func:`lm_logits` computes them."""
    b, s, _ = hidden.shape
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    ck = min(cfg.loss_chunk, s)
    while s % ck:
        ck -= 1
    labels = labels.to(torch.int64)
    mask = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
            if loss_mask is None else loss_mask.to(torch.float32))
    table_f = table.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, ck):
        with full_fp32():
            logits = hidden[:, i:i + ck].float() @ table_f.t()
        logits = softcap(logits, cfg.final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, i:i + ck, None])[..., 0]
        m = mask[:, i:i + ck]
        total = total + ((lse - gold) * m).sum()
        count = count + m.sum()
    return total / torch.clamp(count, min=1.0)


def lm_loss(
    params, tokens: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig, *,
    loss_mask: Optional[torch.Tensor] = None, backend=None,
) -> torch.Tensor:
    """Training loss: the train-mode forward, the chunked cross-entropy and
    ``0.01`` times the MoE load-balancing loss (zero for dense models). A
    config with image rows drops its first ``n_img_tokens`` positions, as
    the reference does (:func:`repro_torch.models.vlm.vlm_loss` is the vlm
    family's loss)."""
    hidden, _, aux = lm_forward(params, tokens, cfg, mode="train", backend=backend)
    if cfg.n_img_tokens:
        hidden = hidden[:, cfg.n_img_tokens:]
    return _chunked_ce(params, hidden, labels, cfg, loss_mask) + 0.01 * aux
