"""The continuous engine on stablelm-12b, gemma2-9b, qwen2.5-32b,
grok-1-314b, jamba-v0.1-52b and xlstm-125m against the JAX engine, on the
CPU, token for token.

Reduced widths with fp32 parameters from the JAX package's ``init_params``
(``tests/test_torch_families.py`` has the model-level parity). Each family
is served monolithic on a Poisson trace whose prompts (5-24 tokens) and
generations cross the reduced gemma2's window of 16, then with chunked
prefill and the prefix cache on a shared-system-prompt trace (a 24-token
prefix), then with int8 K/V lanes; grok dropless (its reduced config) and
with capacity dropping. Outputs, generated tokens, decode steps, prefill
batches and occupancy must be identical, and so must the prefix cache's
counts. jamba and xlstm carry recurrent states in the slot pool: exact-length
prefill buckets, each join copying a state's whole slot row, the int8 pool
narrowing only jamba's attention layer, and chunked prefill and the prefix
cache turned off (with a warning) on both sides. jamba also runs with
capacity dropping, and both run the reference's
``test_continuous_matches_single_request_greedy`` trace, where the engines'
streams must also equal each request served alone by the port's static
engine. Both engines get their fields set explicitly, with the environment
knobs cleared.

The reference's slot pool gives every pattern position one shared lengths
array (``repro/serve/cache.py:76``) and its join donates the pool
(``:106``): with gemma2's two attention positions XLA refuses to donate
one buffer twice. The fixture below hands each position its own copy of the
same zeros, so the reference's engine runs unchanged otherwise.
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
from repro.serve import Request as JRequest
from repro.serve import poisson_trace as j_poisson_trace
from repro.serve import cache as j_cache
from repro.serve import shared_prefix_trace as j_shared_prefix_trace
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import (ContinuousEngine, Request, ServeEngine, poisson_trace,
                               shared_prefix_trace)

FAMILIES = ["stablelm-12b", "gemma2-9b", "qwen2.5-32b", "grok-1-314b", "jamba-v0.1-52b",
            "xlstm-125m"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-125m"]
TRACE = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17, 24), gen_lens=(3, 6, 11),
             mean_interarrival=1.5)
PREFIX_TRACE = dict(seed=2, vocab=256, prefix_len=24, tail_lens=(3, 6), gen_lens=(3, 5),
                    mean_interarrival=1.0)
MODES = {
    "monolithic": ((j_poisson_trace, poisson_trace), 8, TRACE, dict(n_slots=3, max_len=48)),
    "chunked-prefix-cache": ((j_shared_prefix_trace, shared_prefix_trace), 5, PREFIX_TRACE,
                             dict(n_slots=2, max_len=48, prefill_chunk=8, prefix_cache=True,
                                  prefix_block=8)),
    "int8-kv": ((j_poisson_trace, poisson_trace), 6, TRACE,
                dict(n_slots=2, max_len=48, kv_format="int8")),
}


@pytest.fixture(autouse=True)
def _no_env_knobs(monkeypatch):
    for var in ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS",
                "REPRO_SLO_ITL_MS"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(autouse=True)
def _unaliased_reference_pool(monkeypatch):
    orig = j_cache.init_slot_caches

    def init(*args, **kwargs):
        return tuple(c._replace(length=jnp.array(c.length, copy=True))
                     if hasattr(c, "length") else c for c in orig(*args, **kwargs))

    monkeypatch.setattr(j_cache, "init_slot_caches", init)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch, dropless=True):
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    if jcfg.moe is not None and not dropless:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dropless=False))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, dropless=False))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


CASES = [(a, m, True) for a in FAMILIES for m in MODES] + [
    (a, "monolithic", False) for a in ("grok-1-314b", "jamba-v0.1-52b")]


@pytest.mark.parametrize("arch,mode,dropless", CASES,
                         ids=[f"{a}-{m}" + ("" if d else "-capacity") for a, m, d in CASES])
def test_continuous_engine_matches_jax(arch, mode, dropless):
    jcfg, tcfg, jparams, tparams = _model(arch, dropless)
    (j_trace, t_trace), n, trace_kw, fields = MODES[mode]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # capacity dropping warns
        jeng = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32, **fields)
        teng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32, **fields)
    want = jeng.serve(j_trace(n, **trace_kw))
    got = teng.serve(t_trace(n, **trace_kw))
    assert got.outputs == want.outputs
    assert got.generated_tokens == want.generated_tokens
    assert got.decode_steps == want.decode_steps
    assert got.prefill_batches == want.prefill_batches
    assert got.mean_occupancy == want.mean_occupancy
    assert (teng.prefill_chunk, teng.prefix_cache) == (jeng.prefill_chunk, jeng.prefix_cache)
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    recurrent = arch in RECURRENT
    if mode == "chunked-prefix-cache" and recurrent:
        assert teng.prefill_chunk is None and teng.prefix_cache_stats() is None
    elif mode == "chunked-prefix-cache":
        assert teng.prefill_chunk == 8 and teng.prefix_cache_stats()["hits"] > 0
    if mode == "int8-kv":
        # xlstm has no attention layer: nothing to narrow, no K/V bytes.
        assert got.kv_bytes_per_slot == want.kv_bytes_per_slot
        assert (got.kv_bytes_per_slot > 0) == (arch != "xlstm-125m")


def test_slot_pool_keeps_full_width_states_beside_narrow_kv():
    """jamba's int8 pool: the attention layer's K/V narrowed with per-slot
    scales, every mamba state full width in the pool's dtype; a join copies
    each state's whole row into its slot (filler rows dropped) and leaves
    the other slots alone; the K/V bytes a slot equal the reference's."""
    from repro.serve import SlotPool as JSlotPool
    from repro_torch.models import api as tapi
    from repro_torch.models.mamba import MambaState
    from repro_torch.quant.kvcache import QuantKVCache
    from repro_torch.serve import SlotPool

    jcfg, tcfg, _, tparams = _model("jamba-v0.1-52b")
    pool = SlotPool.create(tcfg, 3, 16, torch.float32, "cpu", kv_format="int8")
    kinds = [type(c).__name__ for c in pool.caches]
    assert kinds == ["QuantKVCache" if bd.mixer == "attn" else "MambaState"
                     for bd in tcfg.pattern]
    want = JSlotPool.create(jcfg, 3, 16, jnp.float32, kv_format="int8").kv_bytes_per_slot()
    assert pool.kv_bytes_per_slot() == want > 0
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 6)))
    _, caches = tapi.prefill_bucketed(tcfg, tparams, toks, torch.tensor([6, 6]), torch.float32)
    before = [(c.conv.clone(), c.ssm.clone()) for c in pool.caches if isinstance(c, MambaState)]
    pool.join(caches, [2])  # row 1 is a filler row: dropped
    states = [(c, f) for c, f in zip(pool.caches, caches) if isinstance(c, MambaState)]
    for (c, f), (conv0, ssm0) in zip(states, before):
        torch.testing.assert_close(c.conv[2], f.conv[0], rtol=0, atol=0)
        torch.testing.assert_close(c.ssm[2], f.ssm[0], rtol=0, atol=0)
        torch.testing.assert_close(c.conv[:2], conv0[:2], rtol=0, atol=0)
        torch.testing.assert_close(c.ssm[:2], ssm0[:2], rtol=0, atol=0)
    kv = next(c for c in pool.caches if isinstance(c, QuantKVCache))
    assert kv.k.dtype == torch.int8 and float(kv.k_scale[2].min()) > 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_continuous_matches_single_request_greedy(arch):
    """The reference's ``test_continuous_matches_single_request_greedy``
    trace (5 requests joining and leaving a 2-slot pool): the port's engine
    equals the reference's token for token, and each request served alone
    by the port's static engine."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(7)
    specs = [(7, 5, 0), (12, 9, 0), (7, 3, 2), (16, 11, 5), (12, 1, 9)]
    prompts = [[int(x) for x in rng.integers(0, tcfg.vocab, p)] for p, _, _ in specs]

    def trace(cls):
        return [cls(rid=i, prompt=prompts[i], max_new_tokens=g, arrival=a)
                for i, (_, g, a) in enumerate(specs)]

    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=48,
                       cache_dtype=jnp.float32).serve(trace(JRequest))
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=48,
                           cache_dtype=torch.float32).serve(trace(Request))
    assert got.outputs == want.outputs
    assert (got.decode_steps, got.prefill_batches) == (want.decode_steps, want.prefill_batches)
    alone = ServeEngine(cfg=tcfg, params=tparams, max_len=48, cache_dtype=torch.float32)
    for i, (_, g, _) in enumerate(specs):
        toks = alone.generate({"tokens": torch.tensor([prompts[i]])}, g)
        assert toks[0].tolist() == got.outputs[i], i
    assert got.generated_tokens == sum(g for _, g, _ in specs)
