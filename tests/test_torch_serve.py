"""The port's serving engines against the JAX reference, on the CPU.

Same parameters (carried over from the JAX package's ``init_params``), same
request traces: the lockstep engine's greedy tokens and the continuous
engine's outputs and counters must be identical, and the trace generators
must produce identical requests on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServeEngine as JServe
from repro.serve import poisson_trace as j_poisson_trace
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import ContinuousEngine, ServeEngine, SlotPool, poisson_trace

TRACE = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17, 24), gen_lens=(3, 6, 11),
             mean_interarrival=1.5)


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("chatglm3-6b").reduced()
    tcfg = t_get_config("chatglm3-6b").reduced()
    jparams = japi.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(autouse=True)
def _monolithic_reference(monkeypatch):
    # Both engines read these knobs from the environment; the cases here
    # serve the monolithic path (tests/test_torch_chunked.py: the chunked).
    for var in ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS",
                "REPRO_SLO_ITL_MS"):
        monkeypatch.delenv(var, raising=False)


def _fields(reqs):
    return [(r.rid, list(r.prompt), r.max_new_tokens, r.arrival) for r in reqs]


@pytest.mark.parametrize("n", [1, 9, 25])
def test_poisson_trace_is_identical_on_both_sides(n):
    assert _fields(poisson_trace(n, **TRACE)) == _fields(j_poisson_trace(n, **TRACE))
    assert _fields(poisson_trace(n)) == _fields(j_poisson_trace(n))


def test_static_engine_greedy_tokens_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (3, 10))
    want = JServe(cfg=jcfg, params=jparams, max_len=24, cache_dtype=jnp.float32).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, 12
    )
    got = ServeEngine(cfg=tcfg, params=tparams, max_len=24, cache_dtype=torch.float32).generate(
        {"tokens": torch.from_numpy(toks)}, 12
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_slots", [2, 3])
def test_continuous_engine_matches_jax(model, n_slots):
    jcfg, tcfg, jparams, tparams = model
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=n_slots, max_len=40,
                       cache_dtype=jnp.float32).serve(j_poisson_trace(9, **TRACE))
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=n_slots, max_len=40,
                           cache_dtype=torch.float32).serve(poisson_trace(9, **TRACE))
    assert got.outputs == want.outputs
    assert got.generated_tokens == want.generated_tokens
    assert got.decode_steps == want.decode_steps
    assert got.prefill_batches == want.prefill_batches
    assert got.mean_occupancy == want.mean_occupancy
    assert got.ttft_p50 is not None and got.itl_p50 is not None


def test_continuous_engine_eos_and_streaming_match_jax(model):
    """The synchronous path: EOS eviction and a streaming callback."""
    jcfg, tcfg, jparams, tparams = model
    base = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=40,
                       cache_dtype=jnp.float32).serve(j_poisson_trace(5, **TRACE))
    eos = base.outputs[0][1]  # a token request 0 emits second
    j_stream, t_stream = [], []
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=40,
                       cache_dtype=jnp.float32, eos_id=eos).serve(
        j_poisson_trace(5, **TRACE), on_token=lambda r, t: j_stream.append((r, t)))
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=40,
                           cache_dtype=torch.float32, eos_id=eos).serve(
        poisson_trace(5, **TRACE), on_token=lambda r, t: t_stream.append((r, t)))
    assert got.outputs == want.outputs
    assert t_stream == j_stream
    assert (got.decode_steps, got.prefill_batches) == (want.decode_steps, want.prefill_batches)
    assert got.outputs[0][-1] == eos


def test_unported_engine_options_raise(model):
    # The SLO options are ported (goodput): the engine takes them as given.
    _, tcfg, _, tparams = model
    for kw in ({"slo_ttft_ms": 50.0}, {"slo_itl_ms": 20.0}):
        eng = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32, **kw)
        assert (eng.slo_ttft_ms, eng.slo_itl_ms) == (kw.get("slo_ttft_ms"), kw.get("slo_itl_ms"))


def test_slot_pool_free_list_order_and_idempotent_release():
    tcfg = t_get_config("chatglm3-6b").reduced()
    pool = SlotPool.create(tcfg, 4, 16, torch.float32, "cpu")
    assert pool.allocate(["a", "b", "c"]) == [0, 1, 2]
    assert pool.release(1) is True
    assert pool.release(1) is False  # already free: no-op
    assert pool.allocate(["d", "e"]) == [1, 3]  # lowest-numbered first
    assert pool.leased_hwm == 4 and pool.n_free == 0
    with pytest.raises(KeyError):
        pool.release(4)
    with pytest.raises(RuntimeError):
        pool.allocate(["f"])
