"""The port's attention core with a sliding window and score soft-capping
(gemma2's local layers) against the reference's functions on the same
inputs, on the CPU.

``blockwise_attention`` (prefill, its panel pruning at ``(i * qc -
window) // kc``), ``decode_attention`` (each row at its own fill
point) and ``chunk_attention`` (each query at its own position) on prompts
longer than the window, in fp32 and bf16, against
``repro.models.attention``'s: fp32 within ``rtol = atol = 2e-4`` (the
reference's own attention tolerance; the order of fp32 sums and the exp and
tanh implementations differ), bf16 outputs within two bf16 ulps of the
value (the probabilities round to bf16 before the PV product on both
sides). Rows that no key may reach follow the reference: a decode row with
nothing cached and a prefill row whose every panel is pruned away.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

FP32_TOL = 2e-4


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32) * 2
    k = rng.standard_normal(shape_kv).astype(np.float32) * 2
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


def _pair(x, dtype):
    """One numpy array as (jnp, torch) in ``dtype``; bf16 rounded once by
    torch and carried bitwise to jax."""
    t = torch.from_numpy(x).to(dtype)
    if dtype == torch.bfloat16:
        j = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    else:
        j = jnp.asarray(x)
    return j, t


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


BLOCKWISE = [
    # (S, T, q_chunk, kv_chunk, window, cap, causal)
    (40, 40, 8, 8, 16, 50.0, True),
    (40, 40, 16, 8, 16, None, True),
    (40, 40, 8, 16, 5, 50.0, True),
    (48, 48, 48, 48, 16, 50.0, True),
    (24, 40, 8, 8, 16, 20.0, True),
    (32, 32, 8, 8, None, 3.0, True),
    (32, 32, 8, 8, 12, 50.0, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,t,qc,kc,window,cap,causal", BLOCKWISE,
                         ids=[f"S{c[0]}-T{c[1]}-qc{c[2]}-kc{c[3]}-w{c[4]}-cap{c[5]}-"
                              f"{'causal' if c[6] else 'full'}" for c in BLOCKWISE])
def test_windowed_softcapped_blockwise_matches_the_reference(s, t, qc, kc, window, cap, causal,
                                                             dtype):
    q, k, v = _inputs((2, s, 4, 16), (2, t, 2, 16), seed=s + t + qc + kc)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_chunk=qc, kv_chunk=kc)
    want = jattn.blockwise_attention(jq, jk, jv, **kw)
    got = tattn.blockwise_attention(tq, tk, tv, **kw)
    assert got.dtype == dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window,cap", [(16, 50.0), (16, None), (3, 50.0), (None, 2.0)])
def test_windowed_softcapped_decode_matches_the_reference(window, cap, dtype):
    """Rows at fill points 40, 17, 16 and 3 of a 48-position cache: the
    window hides the older keys of the first two."""
    q, k, v = _inputs((4, 1, 4, 16), (4, 48, 32), seed=7)
    lengths = np.array([40, 17, 16, 3])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = jattn.decode_attention(
        jq, jattn.KVCache(jk, jv, jnp.asarray(lengths, jnp.int32)), n_kv=2, window=window,
        attn_softcap=cap)
    got = tattn.decode_attention(
        tq, tattn.KVCache(tk, tv, torch.from_numpy(lengths)), n_kv=2, window=window,
        attn_softcap=cap)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window,cap", [(16, 50.0), (16, None), (4, 50.0), (None, 2.0)])
def test_windowed_softcapped_chunk_matches_the_reference(window, cap, dtype):
    """An 8-token chunk per row at offsets 0, 13, 30 and 40 of a 48-position
    cache: the later rows' windows start past position 0."""
    q, k, v = _inputs((4, 8, 4, 16), (4, 48, 32), seed=8)
    offsets = np.array([0, 13, 30, 40])
    pos = offsets[:, None] + np.arange(8)[None, :]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = jattn.chunk_attention(
        jq, jattn.KVCache(jk, jv, jnp.asarray(pos[:, -1] + 1, jnp.int32)),
        jnp.asarray(pos, jnp.int32), n_kv=2, window=window, attn_softcap=cap)
    got = tattn.chunk_attention(
        tq, tattn.KVCache(tk, tv, torch.from_numpy(pos[:, -1] + 1)), torch.from_numpy(pos),
        n_kv=2, window=window, attn_softcap=cap)
    _check(got, want, dtype)


def test_fully_masked_rows_follow_the_reference():
    """Rows that no key may reach: a decode row with nothing cached and,
    in a non-causal prefill of 32 queries over 8 keys with a window of 8,
    queries 15 and later. The finite ``NEG_INF`` gives a row whose scanned
    panel is all masked uniform weights, not NaN (queries 15 in the block
    of 8..15); a block whose every panel is pruned gives zeros (16 on)."""
    q, k, v = _inputs((2, 1, 4, 16), (2, 24, 32), seed=9)
    lengths = np.array([0, 10])
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(lengths, jnp.int32)),
        n_kv=2, window=4, attn_softcap=50.0)
    got = tattn.decode_attention(
        torch.from_numpy(q), tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                           torch.from_numpy(lengths)),
        n_kv=2, window=4, attn_softcap=50.0)
    _check(got, want, torch.float32)
    uniform = v.reshape(2, 24, 2, 16)[0].mean(0)  # [Hkv, D]
    np.testing.assert_allclose(got[0, 0].reshape(2, 2, 16).numpy(),
                               np.broadcast_to(uniform[:, None], (2, 2, 16)), rtol=1e-5,
                               atol=1e-5)

    q, k, v = _inputs((1, 32, 4, 16), (1, 8, 2, 16), seed=10)
    kw = dict(causal=False, window=8, q_chunk=8, kv_chunk=8)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw)
    _check(got, want, torch.float32)
    uniform = v[0].mean(0)  # [Hkv, D]
    np.testing.assert_allclose(got[0, 15].reshape(2, 2, 16).numpy(),
                               np.broadcast_to(uniform[:, None], (2, 2, 16)), rtol=1e-5,
                               atol=1e-5)
    assert not got[:, 16:].any()
