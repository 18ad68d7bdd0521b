"""The port's quantized K/V lanes against the JAX reference, on the CPU.

``quantize_kv_rows`` with and without scale floors, the cache's dequant and
its per-token quantization must equal the reference's bit for bit in every
format; ``kv_bytes_per_slot`` must give the reference's number for the same
pool. The continuous engine with an int8 (or fp8) pool, and with the prefix
cache on over a full-precision or an int8 pool, must serve the reference's
greedy tokens token for token, with the same prefix-cache counts; and, as
the reference's own tests ask, the prefix cache on a full-precision pool
must not change a greedy token, and on an int8 pool must not change the
cold request's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.quant import kvcache as jkv
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import SlotPool as JSlotPool
from repro.serve import poisson_trace as j_poisson_trace
from repro.serve import shared_prefix_trace as j_shared_prefix_trace
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.quant import kvcache as tkv
from repro_torch.serve import ContinuousEngine, SlotPool, poisson_trace, shared_prefix_trace

FORMATS = ("int8", "fp8_e4m3", "fp8_e5m2")
N_KV, HD = 2, 4


@pytest.fixture(autouse=True)
def _no_env_knobs(monkeypatch):
    for var in ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS",
                "REPRO_SLO_ITL_MS"):
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = j_get_config("chatglm3-6b").reduced()
    tcfg = t_get_config("chatglm3-6b").reduced()
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _np(t):
    """A tensor as numpy; fp8 by its bytes (numpy has no fp8)."""
    return t.view(torch.uint8).numpy() if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) \
        else t.numpy()


def _jnp(x):
    x = np.asarray(x)
    return x.view(np.uint8) if "float8" in x.dtype.name else x


def _bitwise(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _jnp(w))


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("floors", ["none", "low", "high", "mixed"])
def test_quantize_kv_rows_bitwise(fmt, floors):
    """[rows, S, fused] K/V at magnitudes from 1e-3 to 1e3; floors below
    every scale (recalibrate, never finer), above (adopt), or per head."""
    rng = np.random.default_rng(len(fmt) * 7 + len(floors))
    mag = np.array([1e-3, 1.0, 40.0, 1e3], np.float32)[:, None, None]
    k = (rng.normal(size=(4, 6, N_KV * HD)) * mag).astype(np.float32)
    v = (rng.standard_t(3, size=(4, 6, N_KV * HD)) * mag).astype(np.float32)
    kw_t, kw_j = {}, {}
    if floors != "none":
        fl = {"low": 1e-9, "high": 1e3}.get(floors)
        if fl is None:
            fl_k = np.abs(rng.normal(size=(4, N_KV)) * mag[:, 0]).astype(np.float32) / 50
        else:
            fl_k = np.full((4, N_KV), fl, np.float32)
        fl_v = fl_k[::-1].copy()
        kw_t = dict(k_scale_floor=torch.from_numpy(fl_k), v_scale_floor=torch.from_numpy(fl_v))
        kw_j = dict(k_scale_floor=jnp.asarray(fl_k), v_scale_floor=jnp.asarray(fl_v))
    got = tkv.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v), N_KV, fmt=fmt, **kw_t)
    want = jkv.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v), N_KV, fmt=fmt, **kw_j)
    _bitwise(got, want)
    assert got[0].dtype == tkv.QuantKVCache.zeros(1, 1, 1, 1, fmt).k.dtype


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_cache_dequant_and_append_bitwise(fmt):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, N_KV * HD)).astype(np.float32)
    tc = tkv.quantize_kv(tkv.QuantKVCache(torch.from_numpy(x), torch.from_numpy(2 * x),
                                          None, None, 5), N_KV, fmt=fmt)
    jc = jkv.quantize_kv(jkv.QuantKVCache(jnp.asarray(x), jnp.asarray(2 * x), None, None,
                                          jnp.int32(5)), N_KV, fmt=fmt)
    _bitwise((tc.k, tc.v, tc.k_scale, tc.v_scale), (jc.k, jc.v, jc.k_scale, jc.v_scale))
    _bitwise((tc.dequant_k(), tc.dequant_v(torch.bfloat16).float()),
             (jc.dequant_k(), jc.dequant_v(jnp.bfloat16).astype(jnp.float32)))
    row = rng.normal(size=(3, N_KV * HD)).astype(np.float32) * 3
    _bitwise(tc.quantize_rows(torch.from_numpy(row), torch.from_numpy(-row)),
             jc.quantize_rows(jnp.asarray(row), jnp.asarray(-row)))
    assert tc.n_kv == N_KV and tc.fmt.name == fmt and tc.length == 5


def test_adopt_scale_floor_broadcast():
    s = np.asarray([[0.5, 2.0], [1.0, 4.0]], np.float32)
    got = tkv.adopt_scale_floor(torch.from_numpy(s), 3)
    want = jkv.adopt_scale_floor(jnp.asarray(s), 3)
    assert got.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tkv.adopt_scale_floor(torch.from_numpy(s[0]), 3).numpy(),
                                  np.broadcast_to(s[0], (3, 2)))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
@pytest.mark.parametrize("fmt", (None,) + FORMATS)
def test_kv_bytes_per_slot_equals_the_reference(arch, fmt):
    """Full-width configs (every layer, the real head counts) at a small
    pool: the port's per-layer caches count what the reference's stacks do."""
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    got = SlotPool.create(tcfg, 2, 8, torch.bfloat16, "cpu", kv_format=fmt).kv_bytes_per_slot()
    want = JSlotPool.create(jcfg, 2, 8, jnp.bfloat16, kv_format=fmt).kv_bytes_per_slot()
    assert got == want > 0
    if fmt is not None:
        bf16 = SlotPool.create(tcfg, 2, 8, torch.bfloat16, "cpu").kv_bytes_per_slot()
        assert got <= 0.51 * bf16


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


TRACE = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17), gen_lens=(3, 6), mean_interarrival=1.5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_pool_matches_jax(fmt):
    jcfg, tcfg, jparams, tparams = _model()
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=32, cache_dtype=jnp.float32,
                       kv_format=fmt).serve(j_poisson_trace(6, **TRACE))
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32,
                           cache_dtype=torch.float32, kv_format=fmt).serve(poisson_trace(6, **TRACE))
    assert got.outputs == want.outputs
    assert (got.decode_steps, got.prefill_batches) == (want.decode_steps, want.prefill_batches)
    assert got.kv_bytes_per_slot == want.kv_bytes_per_slot > 0


def test_prefix_cache_matches_jax_and_greedy_features_off():
    """tests/test_serving.py's prefix-cache case: hits, and greedy tokens
    identical to the features-off engine; here also to the reference's."""
    jcfg, tcfg, jparams, tparams = _model()
    kw = dict(seed=3, vocab=256, prefix_len=48, tail_lens=(5, 9), gen_lens=(4, 6),
              mean_interarrival=1.0)
    fields = dict(n_slots=3, max_len=96, prefill_chunk=16, prefix_cache=True, prefix_block=16)
    off = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=3, max_len=96,
                           cache_dtype=torch.float32).serve(shared_prefix_trace(6, **kw))
    jeng = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32, **fields)
    want = jeng.serve(j_shared_prefix_trace(6, **kw))
    teng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32, **fields)
    got = teng.serve(shared_prefix_trace(6, **kw))
    assert got.outputs == want.outputs == off.outputs
    assert (got.decode_steps, got.prefill_batches) == (want.decode_steps, want.prefill_batches)
    stats = teng.prefix_cache_stats()
    assert stats == jeng.prefix_cache_stats()
    assert stats["hits"] > 0 and stats["misses"] >= 1 and stats["cached_tokens"] > 0


def test_int8_pool_with_prefix_cache_matches_jax():
    """tests/test_serving.py's quantized case: hits, the cold request
    identical to the cache-off int8 engine's (later ones adopt the cached
    prefix's scales); and every token the reference's."""
    jcfg, tcfg, jparams, tparams = _model()
    kw = dict(seed=5, vocab=256, prefix_len=32, tail_lens=(5, 7), gen_lens=(4,),
              mean_interarrival=2.0)
    fields = dict(n_slots=2, max_len=64, kv_format="int8", prefill_chunk=16, prefix_cache=True,
                  prefix_block=16)
    off = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=64,
                           cache_dtype=torch.float32, kv_format="int8").serve(
        shared_prefix_trace(4, **kw))
    jeng = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32, **fields)
    want = jeng.serve(j_shared_prefix_trace(4, **kw))
    teng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32, **fields)
    got = teng.serve(shared_prefix_trace(4, **kw))
    assert got.outputs == want.outputs
    assert got.outputs[0] == off.outputs[0]
    assert {r: len(t) for r, t in got.outputs.items()} == {r: len(t) for r, t in off.outputs.items()}
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    assert teng.prefix_cache_stats()["hits"] > 0


def test_launch_serve_takes_kv_format_and_the_knobs(monkeypatch, capsys):
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setenv("REPRO_PREFILL_CHUNK", "8")
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    out = launch_serve.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
                             "--kv-format", "int8", "--n-requests", "4", "--prompt-len", "16",
                             "--gen", "4"])
    assert (out["kv_format"], out["prefill_chunk"]) == ("int8", 8)
    assert out["prefix_cache"]["hits"] + out["prefix_cache"]["misses"] == 4
    bf16 = SlotPool.create(t_get_config("chatglm3-6b").reduced(), 4, 20, torch.float32,
                           "cpu").kv_bytes_per_slot()
    assert 0 < out["kv_bytes_per_slot"] < 0.3 * bf16  # int8 against fp32 lanes
    assert '"kv_format": "int8"' in capsys.readouterr().out
