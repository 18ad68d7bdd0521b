"""The port's chunked prefill against the JAX reference, on the CPU.

``api.prefill_chunk`` at mixed per-row offsets (one row resuming mid-cache,
one running past the bucket, one sentinel row whose writes all drop) must
give the reference's logits and K/V within rtol = atol = 2e-4 (fp32
parameters and caches: only the order of fp32 sums differs). The continuous
engine with ``prefill_chunk`` set must serve the reference's greedy tokens,
token for token, with the same counters; the knobs resolve as the
reference's do. Parameters come from the JAX package's ``init_params`` via
``params_from_numpy``; both engines get their fields set explicitly, with
the environment knobs cleared.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import shared_prefix_trace as j_shared_prefix_trace
from repro.serve import poisson_trace as j_poisson_trace
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.serve import ContinuousEngine, poisson_trace, shared_prefix_trace

TRACE = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17, 24), gen_lens=(3, 6, 11),
             mean_interarrival=1.5)
KNOBS = ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS", "REPRO_SLO_ITL_MS")


@functools.lru_cache(maxsize=None)
def _model(arch="chatglm3-6b", n_layers=None):
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(autouse=True)
def _no_env_knobs(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)


def _serve_both(arch, trace_fn, n, trace_kw, **fields):
    jcfg, tcfg, jparams, tparams = _model(arch)
    jeng = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32, **fields)
    teng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32, **fields)
    return jeng, jeng.serve(trace_fn[0](n, **trace_kw)), teng, teng.serve(trace_fn[1](n, **trace_kw))


def _assert_same_report(got, want):
    assert got.outputs == want.outputs
    assert got.generated_tokens == want.generated_tokens
    assert got.decode_steps == want.decode_steps
    assert got.prefill_batches == want.prefill_batches
    assert got.mean_occupancy == want.mean_occupancy


# ---------------------------------------------------------------------------
# api.prefill_chunk
# ---------------------------------------------------------------------------


ROWS, LB, W = 4, 32, 8
# Row 0 starts a prompt, row 1 resumes at 13, row 2 runs past the bucket
# (positions 32..35 drop), row 3 is a finished row's sentinel (all drop).
OFFSETS = np.array([0, 13, 28, LB])
LAST_IDX = np.array([7, 3, 3, 0])


def test_prefill_chunk_matches_jax_at_mixed_offsets_with_a_sentinel_row():
    jcfg, tcfg, jparams, tparams = _model(n_layers=2)
    rng = np.random.default_rng(1)
    fused = tcfg.n_kv * tcfg.head_dim_
    hist_k = rng.normal(size=(tcfg.n_layers, ROWS, LB, fused)).astype(np.float32)
    hist_v = rng.normal(size=(tcfg.n_layers, ROWS, LB, fused)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab, (ROWS, W))

    jc = japi.init_state(jcfg, ROWS, LB, jnp.float32)
    jc = (jc[0]._replace(k=jnp.asarray(hist_k), v=jnp.asarray(hist_v)),)
    chunk = jax.jit(functools.partial(japi.prefill_chunk, jcfg))
    want_logits, want_c = chunk(jparams, jnp.asarray(toks, jnp.int32), jc,
                                jnp.asarray(OFFSETS, jnp.int32), jnp.asarray(LAST_IDX, jnp.int32))

    tc = tapi.init_state(tcfg, ROWS, LB, torch.float32, "cpu")
    for layer, c in enumerate(tc):
        c.k.copy_(torch.from_numpy(hist_k[layer]))
        c.v.copy_(torch.from_numpy(hist_v[layer]))
    got_logits, got_c = tapi.prefill_chunk(
        tcfg, tparams, torch.from_numpy(toks), tc, torch.from_numpy(OFFSETS),
        torch.from_numpy(LAST_IDX))

    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=2e-4, atol=2e-4)
    for layer, c in enumerate(got_c):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(want_c[0].k[layer]), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(want_c[0].v[layer]), rtol=2e-4, atol=2e-4)
        assert c.length.tolist() == (OFFSETS + W).tolist()
    # The sentinel row and the dropped tail wrote nothing.
    for layer, c in enumerate(got_c):
        np.testing.assert_array_equal(c.k[3].numpy(), hist_k[layer, 3])
        np.testing.assert_array_equal(c.k[0, W:].numpy(), hist_k[layer, 0, W:])


def test_chunk_into_a_quantized_cache_raises():
    _, tcfg, _, tparams = _model()
    from repro_torch.quant.kvcache import QuantKVCache

    qc = [QuantKVCache.zeros(2, 16, tcfg.n_kv, tcfg.head_dim_)]
    with pytest.raises(NotImplementedError, match="chunked prefill into a QuantKVCache"):
        tapi.prefill_chunk(tcfg, tparams, torch.zeros((2, 4), dtype=torch.int64), qc,
                           torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="prefill into a QuantKVCache"):
        from repro_torch.models import transformer as tf_mod

        tf_mod.lm_forward(tparams, torch.zeros((2, 4), dtype=torch.int64), tcfg,
                          mode="prefill", caches=qc)


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots", [2, 3])
def test_continuous_chunked_prefill_matches_jax(n_slots):
    _, want, _, got = _serve_both(
        "chatglm3-6b", (j_poisson_trace, poisson_trace), 9, TRACE,
        n_slots=n_slots, max_len=40, prefill_chunk=8)
    _assert_same_report(got, want)


def test_continuous_chunked_prefill_with_eos_and_streaming_matches_jax():
    jcfg, tcfg, jparams, tparams = _model()
    base = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=40,
                       cache_dtype=jnp.float32, prefill_chunk=8).serve(j_poisson_trace(5, **TRACE))
    eos = base.outputs[0][1]
    j_stream, t_stream = [], []
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=40, cache_dtype=jnp.float32,
                       prefill_chunk=8, eos_id=eos).serve(
        j_poisson_trace(5, **TRACE), on_token=lambda r, t: j_stream.append((r, t)))
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=40,
                           cache_dtype=torch.float32, prefill_chunk=8, eos_id=eos).serve(
        poisson_trace(5, **TRACE), on_token=lambda r, t: t_stream.append((r, t)))
    _assert_same_report(got, want)
    assert t_stream == j_stream


def test_moe_chunked_prefill_with_prefix_cache_matches_jax():
    kw = dict(seed=2, vocab=256, prefix_len=24, tail_lens=(3, 6), gen_lens=(3, 5),
              mean_interarrival=1.0)
    jeng, want, teng, got = _serve_both(
        "deepseek-moe-16b", (j_shared_prefix_trace, shared_prefix_trace), 5, kw,
        n_slots=2, max_len=48, prefill_chunk=8, prefix_cache=True, prefix_block=8)
    _assert_same_report(got, want)
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.prefix_cache_stats()["hits"] > 0


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------


def test_prefill_chunk_must_be_a_power_of_two():
    _, tcfg, _, tparams = _model()
    with pytest.raises(ValueError, match="power of two"):
        ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32, prefill_chunk=12)


def test_env_knobs_turn_both_features_on(monkeypatch):
    jcfg, tcfg, jparams, tparams = _model()
    monkeypatch.setenv("REPRO_PREFILL_CHUNK", "16")
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=32)
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32)
    assert (got.prefill_chunk, got.prefix_cache) == (want.prefill_chunk, want.prefix_cache) == (16, True)
    # Fields beat the environment.
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32,
                           prefill_chunk=8, prefix_cache=False)
    assert (got.prefill_chunk, got.prefix_cache) == (8, False)
    assert got.prefix_cache_stats() is None


@pytest.mark.parametrize("value", ["", "0", "false", "no", "NO"])
def test_prefix_cache_env_off_values(monkeypatch, value):
    _, tcfg, _, tparams = _model()
    monkeypatch.setenv("REPRO_PREFIX_CACHE", value)
    eng = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32)
    assert not eng.prefix_cache and eng.prefill_chunk is None


def test_prefix_cache_alone_implies_a_chunk_of_32():
    jcfg, tcfg, jparams, tparams = _model()
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=32, prefix_cache=True)
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32, prefix_cache=True)
    assert got.prefill_chunk == want.prefill_chunk == 32
    assert got.prefix_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0,
                                        "cached_tokens": 0}


def test_recurrent_pattern_disables_both_features():
    """The reference warns and turns both features off for a pattern that is
    not attention-only; so does the port, for the jamba it now serves."""
    _, _, _, tparams = _model()
    jamba = t_get_config("jamba-v0.1-52b").reduced()
    with pytest.warns(RuntimeWarning, match="attention-only"):
        eng = ContinuousEngine(cfg=jamba, params=tparams, n_slots=2, max_len=32,
                               prefill_chunk=8, prefix_cache=True)
    assert eng.prefill_chunk is None and not eng.prefix_cache
    assert eng.prefix_cache_stats() is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JContinuous(cfg=j_get_config("jamba-v0.1-52b").reduced(), params=None,
                           n_slots=2, max_len=32, prefill_chunk=8, prefix_cache=True)
    assert jeng.prefill_chunk is None and not jeng.prefix_cache

