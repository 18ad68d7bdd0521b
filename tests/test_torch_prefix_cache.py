"""The port's radix prefix cache against the JAX reference's, on the CPU.

The cases of ``tests/test_prefix_cache.py``, each run on both tries with the
same prompts and the same K/V: match results, inserted block counts and the
trie's state (its blocks, refcounts, LRU clocks, node count, evictions) must
be identical; a full-precision gather gives back the inserted K/V exactly;
a quantized trie's codes, scales and gather floors equal the reference's
bit for bit, and quantizing a gathered span again under its floors gives
back the stored codes (scale adoption), for int8 and both fp8 formats.

The reference stacks layers as ``[n_periods, rows, Lb, fused]`` in one
cache entry; the port keeps one ``[rows, Lb, fused]`` cache per layer.
Period ``p`` of the reference's entry is the port's layer ``p``; each side
also carries one entry without K/V (``None``) after it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import KVCache as JKVCache
from repro.quant.kvcache import quantize_kv_rows as j_quantize_kv_rows
from repro.serve import PrefixCache as JPrefixCache
from repro_torch.models.attention import KVCache
from repro_torch.quant.kvcache import quantize_kv_rows
from repro_torch.serve import PrefixCache, PrefixNode

N_PERIODS = 2
FUSED = 8  # n_kv = 2 heads of head_dim 4
N_KV = 2
FORMATS = ("int8", "fp8_e4m3", "fp8_e5m2")


def _stacks(seed, lb, rows=1, scale=1.0):
    """The same standalone prefill caches on both sides."""
    rng = np.random.default_rng(seed)
    shape = (N_PERIODS, rows, lb, FUSED)
    k = (rng.normal(size=shape) * scale).astype(np.float32)
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    j = (JKVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.zeros((rows,), jnp.int32)), None)
    t = [KVCache(torch.from_numpy(k[p]), torch.from_numpy(v[p]),
                 torch.zeros((rows,), dtype=torch.int64)) for p in range(N_PERIODS)]
    return j, t + [None]


def _prompt(rng, n, vocab=64):
    return [int(x) for x in rng.integers(0, vocab, n)]


def _tries(**kw):
    return JPrefixCache(**kw), PrefixCache(**kw)


def _state(trie):
    """The trie's blocks with their refcounts and LRU clocks, and its
    counters, in a form both packages share."""
    nodes = []
    stack = [((), trie._root)]
    while stack:
        path, n = stack.pop()
        for blk, child in n.children.items():
            nodes.append((path + (blk,), child.refcount, child.last_used))
            stack.append((path + (blk,), child))
    return (sorted(nodes), trie.n_nodes, trie.cached_tokens, trie.evictions, trie._clock,
            trie.hits, trie.misses)


def _both(jt, tt, method, *args):
    """``method`` on both tries, args given as (reference, port) pairs."""
    out_j = getattr(jt, method)(*[a[0] for a in args])
    out_t = getattr(tt, method)(*[a[1] for a in args])
    return out_j, out_t


def _same(x):
    return (x, x)


def _match(jt, tt, toks):
    (jpath, jm), (tpath, tm) = _both(jt, tt, "match", _same(toks))
    assert tm == jm and [n.block for n in tpath] == [n.block for n in jpath]
    return jpath, tpath, tm


def _insert(jt, tt, toks, plen, stacks, row=0):
    j_created, t_created = _both(jt, tt, "insert", _same(toks), _same(plen), stacks, _same(row))
    assert t_created == j_created
    assert _state(tt) == _state(jt)
    return t_created


# ---------------------------------------------------------------------------
# trie invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,plen,bs", [(0, 1, 2), (1, 7, 3), (2, 16, 4), (3, 17, 4),
                                          (4, 40, 8), (5, 33, 5), (6, 24, 6)])
def test_match_block_aligned_and_capped(seed, plen, bs):
    rng = np.random.default_rng(seed)
    jt, tt = _tries(block_size=bs, capacity_tokens=1 << 12)
    toks = _prompt(rng, plen)
    _insert(jt, tt, toks, plen, _stacks(seed, plen))
    _, tpath, matched = _match(jt, tt, toks)
    assert matched % bs == 0 and matched <= len(toks) - 1
    assert matched == min((plen // bs) * bs, ((len(toks) - 1) // bs) * bs)
    assert len(tpath) == matched // bs
    assert _state(tt) == _state(jt)


@pytest.mark.parametrize("seed,n_tails", [(0, 2), (1, 4), (2, 6)])
def test_shared_prefix_unique_tails_share_blocks(seed, n_tails):
    rng = np.random.default_rng(seed)
    bs = 4
    jt, tt = _tries(block_size=bs, capacity_tokens=1 << 12)
    prefix = _prompt(rng, 3 * bs)
    first = prefix + _prompt(rng, 5)
    assert _insert(jt, tt, first, len(first), _stacks(seed, 32)) == len(first) // bs
    for j in range(n_tails):
        p = prefix + [100 + j] * 5
        _, _, matched = _match(jt, tt, p)
        assert matched >= len(prefix)
        n0 = tt.n_nodes
        _insert(jt, tt, p, len(p), _stacks(seed + j + 1, 32))
        assert tt.n_nodes - n0 == len(p) // bs - matched // bs


def test_trie_deterministic_match_and_insert():
    rng = np.random.default_rng(0)
    jt, tt = _tries(block_size=4, capacity_tokens=1 << 12)
    toks = _prompt(rng, 13)
    assert _match(jt, tt, toks)[2] == 0 and tt.misses == 0
    assert _insert(jt, tt, toks, 13, _stacks(1, 16)) == 3 and tt.cached_tokens == 12
    assert _match(jt, tt, toks)[2] == 12
    assert _match(jt, tt, toks[:12])[2] == 8
    assert _match(jt, tt, toks[:4] + [99] * 9)[2] == 4
    assert _insert(jt, tt, toks, 13, _stacks(2, 16)) == 0  # first writer wins
    assert _state(tt) == _state(jt)


def test_refcount_blocks_eviction_release_enables_it():
    rng = np.random.default_rng(3)
    bs = 4
    jt, tt = _tries(block_size=bs, capacity_tokens=2 * bs)
    a = _prompt(rng, 2 * bs + 1)
    _insert(jt, tt, a, len(a), _stacks(0, 16))
    jpath, tpath, matched = _match(jt, tt, a)
    assert matched == 2 * bs
    jt.acquire(jpath)
    tt.acquire(tpath)
    b = [200 + t for t in _prompt(rng, 2 * bs + 1)]
    _insert(jt, tt, b, len(b), _stacks(1, 16))
    assert _match(jt, tt, a)[2] == 2 * bs  # pinned: survived
    assert _match(jt, tt, b)[2] < 2 * bs  # b paid the eviction
    assert tt.cached_tokens <= tt.capacity_tokens and tt.evictions > 0
    jt.release(jpath)
    tt.release(tpath)
    _match(jt, tt, b)
    c = [400 + t for t in _prompt(rng, 2 * bs + 1)]
    _insert(jt, tt, c, len(c), _stacks(2, 16))
    assert _match(jt, tt, a)[2] < 2 * bs
    assert _state(tt) == _state(jt)
    with pytest.raises(AssertionError):
        tt.release(tpath)


def test_gather_fp_roundtrip_exact_and_payloads_are_copies():
    rng = np.random.default_rng(7)
    jt, tt = _tries(block_size=4, capacity_tokens=1 << 12)
    toks = _prompt(rng, 9)
    jstack, tstack = _stacks(5, 16)
    _insert(jt, tt, toks, 9, (jstack, tstack))
    jpath, tpath, matched = _match(jt, tt, toks)
    assert matched == 8
    spans, floors = tt.gather(tpath)
    jspans, _ = jt.gather(jpath)
    assert floors is None and spans[-1] is None and len(spans) == N_PERIODS + 1
    for p in range(N_PERIODS):
        k, v = spans[p]
        assert torch.equal(k, tstack[p].k[0, :8]) and torch.equal(v, tstack[p].v[0, :8])
        np.testing.assert_array_equal(k.numpy(), np.asarray(jspans[0][0][p]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jspans[0][1][p]))
    assert tt.gather(tpath) is tt.gather(tpath)  # memoized
    # Each block holds a copy, not a view pinning the prefill's buffer.
    for node in tpath:
        for p in range(N_PERIODS):
            for x, buf in zip(node.payload[p], (tstack[p].k, tstack[p].v)):
                assert x.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
    tstack[0].k.zero_()
    np.testing.assert_array_equal(torch.cat([n.payload[0][0] for n in tpath]).numpy(),
                                  np.asarray(jspans[0][0][0]))


def test_insertion_refuses_quantized_caches():
    from repro_torch.quant.kvcache import QuantKVCache

    trie = PrefixCache(block_size=4)
    with pytest.raises(TypeError, match="full-precision"):
        trie.insert(list(range(9)), 9, [QuantKVCache.zeros(1, 16, N_KV, 4)], 0)


# ---------------------------------------------------------------------------
# quantized trie: codes, scales, floors and scale adoption, bitwise
# ---------------------------------------------------------------------------


def _np(t):
    """A tensor as numpy; fp8 by its bytes (numpy has no fp8)."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp(x):
    """A reference array as numpy; fp8 by its bytes."""
    x = np.asarray(x)
    return x.view(np.uint8) if "float8" in x.dtype.name else x


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_trie_codes_floors_and_adoption_bitwise(fmt):
    rng = np.random.default_rng(11)
    jt, tt = _tries(block_size=4, capacity_tokens=1 << 12, kv_format=fmt, n_kv=N_KV)
    toks = _prompt(rng, 9)
    _insert(jt, tt, toks, 9, _stacks(9, 16, scale=3.0))
    jpath, tpath, matched = _match(jt, tt, toks)
    assert matched == 8
    for jn, tn in zip(jpath, tpath):
        for p in range(N_PERIODS):
            for x, y in zip(tn.payload[p], jn.payload[0]):
                np.testing.assert_array_equal(_np(x), _jnp(y[p]))
        assert tn.payload[-1] is None and jn.payload[1] is None
    spans, floors = tt.gather(tpath)
    jspans, jfloors = jt.gather(jpath)
    assert floors[-1] is None
    for p in range(N_PERIODS):
        (k, v), (k_fl, v_fl) = spans[p], floors[p]
        assert k_fl.shape == (N_KV,)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jspans[0][0][p]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jspans[0][1][p]))
        np.testing.assert_array_equal(k_fl.numpy(), np.asarray(jfloors[0][0][p]))
        np.testing.assert_array_equal(v_fl.numpy(), np.asarray(jfloors[0][1][p]))
        # Scale adoption: quantizing the gathered span under its floors
        # gives back the stored codes and the floors themselves.
        k_q2, v_q2, k_s2, v_s2 = quantize_kv_rows(
            k[None], v[None], N_KV, fmt=fmt, k_scale_floor=k_fl[None], v_scale_floor=v_fl[None])
        want_k = torch.cat([n.payload[p][0] for n in tpath])
        want_v = torch.cat([n.payload[p][1] for n in tpath])
        np.testing.assert_array_equal(_np(k_q2[0]), _np(want_k))
        np.testing.assert_array_equal(_np(v_q2[0]), _np(want_v))
        assert torch.equal(k_s2[0], k_fl) and torch.equal(v_s2[0], v_fl)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scale_adoption_roundtrip_bitwise(fmt, seed):
    """``cast(q * s / s) == q``: a dequantized span plus a small suffix,
    quantized again with the span's scales as floors, keeps the scales and
    the codes; the same on the reference, bit for bit."""
    rng = np.random.default_rng(seed)
    span, tail = 8, 4
    kf = rng.normal(size=(1, span, FUSED)).astype(np.float32)
    vf = rng.normal(size=(1, span, FUSED)).astype(np.float32)
    k_q, v_q, k_s, v_s = quantize_kv_rows(torch.from_numpy(kf), torch.from_numpy(vf), N_KV, fmt=fmt)
    jk_q, jv_q, jk_s, jv_s = j_quantize_kv_rows(jnp.asarray(kf), jnp.asarray(vf), N_KV, fmt=fmt)
    for x, y in ((k_q, jk_q), (v_q, jv_q), (k_s, jk_s), (v_s, jv_s)):
        np.testing.assert_array_equal(_np(x), _jnp(y))

    def deq(q, s):
        x = q.reshape(1, span, N_KV, FUSED // N_KV).float() * s[:, None, :, None]
        return x.reshape(1, span, FUSED)

    small = torch.full((1, tail, FUSED), 1e-4)
    k_full = torch.cat([deq(k_q, k_s), small], dim=1)
    v_full = torch.cat([deq(v_q, v_s), small], dim=1)
    k_q2, v_q2, k_s2, v_s2 = quantize_kv_rows(
        k_full, v_full, N_KV, fmt=fmt, k_scale_floor=k_s, v_scale_floor=v_s)
    assert torch.equal(k_s2, k_s) and torch.equal(v_s2, v_s)
    np.testing.assert_array_equal(_np(k_q2[:, :span]), _np(k_q))
    np.testing.assert_array_equal(_np(v_q2[:, :span]), _np(v_q))
    jk_q2, jv_q2, jk_s2, jv_s2 = j_quantize_kv_rows(
        jnp.asarray(k_full.numpy()), jnp.asarray(v_full.numpy()), N_KV, fmt=fmt,
        k_scale_floor=jk_s, v_scale_floor=jv_s)
    for x, y in ((k_q2, jk_q2), (v_q2, jv_q2), (k_s2, jk_s2), (v_s2, jv_s2)):
        np.testing.assert_array_equal(_np(x), _jnp(y))


def test_quant_trie_requires_n_kv_and_block_size():
    with pytest.raises(ValueError):
        PrefixCache(kv_format="int8")
    with pytest.raises(ValueError):
        PrefixCache(block_size=0)
    assert PrefixNode(block=(), parent=None).gathered is None
