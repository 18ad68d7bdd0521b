"""The port's mamba mixer (``repro_torch.models.mamba``) against the JAX
reference's (``repro.models.mamba``), on the CPU.

Parameters come from the reference's ``mamba_init`` at the reduced
jamba-v0.1-52b's width (d_model 64, d_inner 128, d_state 16, d_conv 4,
dt_rank 4) in fp32, inputs from a numpy seed. Outputs, the returned state
and decode steps from it must agree within ``FP32_TOL`` (relative and
absolute): the prefix scan inside a chunk combines the same pairs as the
reference's ``associative_scan`` in another order, so only fp32 rounding
differs. Sequence lengths: a multiple of the scan chunk (8), a prime (the
chunk shrinks to 1), and one shorter than the conv window (its history is
zero-padded); S = 1 runs through the block, where a cache turns it into a
decode step, as in the reference.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import mamba as jmamba
from repro.models import transformer as jtf
from repro.models.layers import Initializer as JInit
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttf
from repro_torch.tree import map_leaves

FP32_TOL = 2e-4
ARCH = "jamba-v0.1-52b"
CHUNK = 8


@functools.lru_cache(maxsize=None)
def _params():
    cfg = t_get_config(ARCH).reduced()
    m = cfg.mamba
    jp = jmamba.mamba_init(jax.random.key(3), cfg.d_model, expand=m.expand, d_state=m.d_state,
                           d_conv=m.d_conv, init=JInit(dtype=jnp.float32))
    tp = map_leaves(lambda x: tensor_from_numpy(np.asarray(x), "cpu"), dict(jp))
    return cfg, jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_TOL, atol=FP32_TOL)


def _state_close(got, want):
    _close(got.conv, want.conv)
    _close(got.ssm, want.ssm)


def test_init_matches_the_reference_leaf_for_leaf_in_shape_dtype_and_constants():
    cfg, jp, _ = _params()
    m = cfg.mamba
    from repro_torch.models.layers import Initializer

    tp = tmamba.mamba_init(cfg.d_model, Initializer(dtype=torch.float32), expand=m.expand,
                           d_state=m.d_state, d_conv=m.d_conv)
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).removeprefix("torch.") == str(jp[k].dtype), k
    for k in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
    # log(1..N): the two libraries' logs may round one ulp apart.
    np.testing.assert_allclose(_np(tp["A_log"]), np.asarray(jp["A_log"]), rtol=2.4e-7, atol=0)
    assert jp["x_proj"].shape[1] == 4 + 2 * m.d_state  # dt_rank = ceil(64 / 16)


def test_prefix_scan_equals_the_sequential_recurrence():
    gen = torch.Generator().manual_seed(0)
    for n in (1, 2, 5, 8, 13):
        a = torch.rand((2, n, 3, 4), generator=gen)
        b = torch.randn((2, n, 3, 4), generator=gen)
        a_cum, b_cum = tmamba._prefix_scan(a, b)
        h = torch.zeros((2, 3, 4))
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            torch.testing.assert_close(b_cum[:, t], h, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(a_cum[:, -1], torch.prod(a, dim=1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("s", [16, 13, 2], ids=["chunk-multiple", "prime", "shorter-than-conv"])
def test_apply_and_its_state_match_jax(s):
    _, jp, tp = _params()
    x = _x((2, s, 64), seed=s)
    want, wstate = jmamba.mamba_apply(jp, jnp.asarray(x), chunk=CHUNK, backend="xla",
                                      return_state=True)
    got, gstate = tmamba.mamba_apply(tp, torch.from_numpy(x), chunk=CHUNK, return_state=True)
    _close(got, want)
    _state_close(gstate, wstate)
    plain = tmamba.mamba_apply(tp, torch.from_numpy(x), chunk=CHUNK)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_chunk_length_does_not_change_the_result():
    """One chunk of 16, two of 8 and sixteen of 1 compute one recurrence."""
    _, _, tp = _params()
    x = torch.from_numpy(_x((1, 16, 64), seed=5))
    outs = [tmamba.mamba_apply(tp, x, chunk=c, return_state=True) for c in (16, 8, 1)]
    for out, state in outs[1:]:
        _close(out, outs[0][0])
        _state_close(state, outs[0][1])


def test_decode_steps_from_the_prefill_state_match_jax():
    _, jp, tp = _params()
    x = _x((2, 12, 64), seed=7)
    _, wstate = jmamba.mamba_apply(jp, jnp.asarray(x), chunk=CHUNK, backend="xla",
                                   return_state=True)
    _, gstate = tmamba.mamba_apply(tp, torch.from_numpy(x), chunk=CHUNK, return_state=True)
    for i in range(4):
        xt = _x((2, 1, 64), seed=20 + i)
        want, wstate = jmamba.mamba_decode_step(jp, jnp.asarray(xt), wstate, backend="xla")
        got, gstate = tmamba.mamba_decode_step(tp, torch.from_numpy(xt), gstate)
        _close(got, want)
        _state_close(gstate, wstate)


def test_decode_continues_the_sequence_it_was_prefilled_with():
    """A prefill of S tokens then one decode step equals the last row of a
    prefill of S + 1 tokens: the conv window and the ssm state carry over."""
    _, _, tp = _params()
    x = torch.from_numpy(_x((2, 10, 64), seed=9))
    full = tmamba.mamba_apply(tp, x, chunk=CHUNK)
    _, state = tmamba.mamba_apply(tp, x[:, :9], chunk=CHUNK, return_state=True)
    step, _ = tmamba.mamba_decode_step(tp, x[:, 9:], state)
    _close(step[:, 0], full[:, 9])


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("cached", [True, False], ids=["decode-branch", "no-cache"])
def test_one_token_through_the_block_matches_jax(cached):
    """S = 1 through a ``("mamba", "mlp")`` block: with a cache it is the
    decode step from that state (the new state returned), without one the
    full-sequence form."""
    jcfg, tcfg, jparams, tparams = _model()
    bd = tcfg.pattern[0]
    assert (bd.mixer, bd.ffn) == ("mamba", "mlp")
    jblock = jax.tree.map(lambda a: a[0], jparams["blocks"][0])
    x = _x((2, 1, tcfg.d_model), seed=11)
    pos = np.zeros((2, 1), np.int32)
    jcache = tcache = None
    if cached:
        h = _x((2, 6, tcfg.d_model), seed=12)
        _, jcache = jmamba.mamba_apply(jblock["mamba"], jnp.asarray(h), chunk=CHUNK,
                                       return_state=True)
        _, tcache = tmamba.mamba_apply(tparams["blocks"][0]["mamba"], torch.from_numpy(h),
                                       chunk=CHUNK, return_state=True)
    want, wcache, _ = jtf._block_apply(jcfg, bd, jblock, jnp.asarray(x),
                                       positions=jnp.asarray(pos), cache=jcache, backend="xla")
    got, gcache, _ = ttf._block_apply(tcfg, bd, tparams["blocks"][0], torch.from_numpy(x),
                                      positions=torch.from_numpy(pos).long(), cache=tcache,
                                      backend=None)
    _close(got, want)
    if cached:
        _state_close(gcache, wcache)
    else:
        assert gcache is None


def test_one_token_prefill_through_the_model_matches_jax():
    """A 1-token prompt: every mamba layer takes its decode step from the
    zero state, the attention layer its decode branch, as in the reference."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = np.array([[3], [77]])
    want, wc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, 8,
                            jnp.float32, backend="xla")
    got, gc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 8, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    for layer, c in enumerate(gc):
        pos, period = layer % len(tcfg.pattern), layer // len(tcfg.pattern)
        if isinstance(c, tmamba.MambaState):
            _state_close(c, jax.tree.map(lambda a: a[period], wc[pos]))


def test_chunked_prefill_raises_for_a_recurrent_mixer():
    _, tcfg, _, tparams = _model()
    caches = tapi.init_state(tcfg, 1, 16, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="attention mixers"):
        tapi.prefill_chunk(tcfg, tparams, torch.zeros((1, 4), dtype=torch.int64), caches,
                           torch.zeros(1, dtype=torch.int64), torch.full((1,), 3))


def _saved_bytes(tp, x):
    """Bytes autograd keeps for the backward of ``mamba_apply`` outside any
    checkpoint (a checkpointed region's saved tensors are its own)."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tmamba.mamba_apply(tp, x, chunk=CHUNK).sum()
    return sum(saved)


def test_backward_keeps_no_chunk_expansion():
    """As the reference's ``jax.checkpoint`` of its chunk step: under
    autograd each chunk's ``[B, ck, Di, N]`` expansion is recomputed in the
    backward, not kept. What is kept grows by less than two expansion rows
    ``Di x N`` (fp32) a token between S = 32 and S = 64; without the
    checkpoint it grows by more than ten."""
    _, _, tp = _params()
    tp = map_leaves(lambda t: t.clone().requires_grad_(True), tp)
    b, (di, n) = 2, tp["A_log"].shape
    grown = [_saved_bytes(tp, torch.from_numpy(_x((b, s, 64), seed=s)).requires_grad_(True))
             for s in (32, 64)]
    assert grown[1] - grown[0] < 2 * b * 32 * di * n * 4, grown


def test_gradients_through_the_checkpointed_chunks_match_jax():
    _, jp, tp = _params()
    x = _x((2, 24, 64), seed=9)
    w = _x((2, 24, 64), seed=10)

    def jloss(p, xx):
        return jnp.sum(jmamba.mamba_apply(p, xx, chunk=CHUNK, backend="xla") * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = map_leaves(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tmamba.mamba_apply(tp, tx, chunk=CHUNK) * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx)
    for k in jp:
        scale = float(np.abs(np.asarray(jg[k])).max()) or 1.0
        np.testing.assert_allclose(_np(tp[k].grad) / scale, np.asarray(jg[k]) / scale,
                                   rtol=0, atol=FP32_TOL, err_msg=k)
