"""The port's quantized serving path against the JAX reference, on the CPU:
reduced chatglm3-6b under ``mlp_q8_policy`` (with and without a calibrated
``requant_int8`` lane) and reduced deepseek-moe-16b under
``PrecisionPolicy(rules={"moe": "q8"})``, through ``api.prefill`` and
``api.decode`` as the reference's ``benchmarks/quant_bench.py::greedy_decode``
drives them (fp32 caches, greedy).

Parameters come from the JAX package's ``init_params`` (fp32 at reduced
width); the JAX side runs ``xla_q8`` (what its ``"q8"`` resolves to on the
CPU), the port ``torch_q8``. The weights quantize bit for bit alike; the
activations enter the int8 GEMMs after fp32 work whose sums run in another
order on the two sides (attention, norms), so an int8 value can round the
other way where it lies within an fp32 ulp of a rounding boundary. One such
step moves a logit by ``scale * |w|``, far below the tolerance (``LOGIT_REL
* max(1, max|logits|)``, ``LOGIT_REL = 1e-4``); the runs here see no such flip (max |dlogits| about
2e-7). Greedy tokens must be identical over 8 decode steps, and MoE routing
identical; on a token mismatch the message names the first int8 activation
that differs between the two sides and how far its value lay from the
rounding boundary.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.quant import backends as jqb
from repro_torch import quant as tq
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.quant import backends as tqb

MAX_LEN = 32
LOGIT_REL = 1e-4
DECODE_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_REL * max(1.0, float(np.abs(want).max())))


def _record_quantize(monkeypatch):
    """Record every (input, int8 values, scale) the q8 backends quantize,
    on both sides, in call order."""
    jrec, trec = [], []

    def jwrap(x, fmt="int8", *, axis=None, _orig=jqb.quantize):
        out = _orig(x, fmt, axis=axis)
        jrec.append((np.asarray(x, np.float32), np.asarray(out.q), np.asarray(out.scale)))
        return out

    def twrap(x, fmt="int8", *, axis=None, _orig=tqb.quantize):
        out = _orig(x, fmt, axis=axis)
        trec.append((x.float().numpy(), out.q.numpy(), out.scale.numpy()))
        return out

    monkeypatch.setattr(jqb, "quantize", jwrap)
    monkeypatch.setattr(tqb, "quantize", twrap)
    return jrec, trec


def _first_int8_difference(jrec, trec):
    """Where the two sides' int8 operands first differ, and why."""
    for i, ((jx, jq_, js), (tx, tq_, ts)) in enumerate(zip(jrec, trec)):
        bad = np.argwhere(jq_ != tq_)
        if len(bad):
            at = tuple(bad[0])
            sj = np.broadcast_to(js, jx.shape)[at]
            st = np.broadcast_to(ts, tx.shape)[at]
            return (f"quantized operand #{i} {jx.shape} first differs at {at}: int8 "
                    f"{jq_[at]} (JAX) vs {tq_[at]} (port) from x/scale = {jx[at] / sj!r} vs "
                    f"{tx[at] / st!r} (scales {sj!r} vs {st!r}): the fp32 input lay that "
                    f"close to a rounding boundary")
    return "no int8 operand differs"


def _greedy_both(monkeypatch, arch, jpol, tpol, seed):
    """Prefill 2 prompts of 11 tokens, then DECODE_STEPS greedy steps on each
    side, holding logits and tokens; returns the recorded int8 operands of
    each side. The JAX side runs with jit disabled, so its
    layer scan runs eagerly and every operand is recorded by value."""
    with jax.disable_jit():
        return _greedy_both_eager(monkeypatch, arch, jpol, tpol, seed)


def _greedy_both_eager(monkeypatch, arch, jpol, tpol, seed):
    jcfg, tcfg, jparams, tparams = _model(arch)
    jrec, trec = _record_quantize(monkeypatch)
    toks = np.random.default_rng(seed).integers(0, tcfg.vocab, (2, 11))
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN,
                          jnp.float32, backend=jpol)
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                          torch.float32, backend=tpol)
    for i in range(DECODE_STEPS + 1):
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        assert np.array_equal(ttok.numpy(), jtok), (
            f"greedy token {i} differs: {ttok.ravel().tolist()} vs {jtok.ravel().tolist()}; "
            + _first_int8_difference(jrec, trec))
        if i == DECODE_STEPS:
            break
        jl, jc = japi.decode(jcfg, jparams, jnp.asarray(jtok, jnp.int32), jc, jnp.int32(11 + i),
                             backend=jpol)
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, 11 + i, backend=tpol)
    assert len(jrec) == len(trec) > 0
    return jrec, trec


def test_chatglm_under_mlp_q8_policy_matches_jax(monkeypatch):
    jrec, trec = _greedy_both(monkeypatch, "chatglm3-6b", jq.mlp_q8_policy(moe=False),
                                   tq.mlp_q8_policy(moe=False), seed=3)
    # Every int8 operand (the weights and the activations) holds the same
    # values; a scale is the same bits where its input was, and else differs
    # as little as the fp32 amax it came from.
    for (jx, jq_, js), (tx, tq_, ts) in zip(jrec, trec):
        np.testing.assert_array_equal(tq_, jq_)
        if np.array_equal(tx, jx):
            np.testing.assert_array_equal(ts, js)
        else:
            np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)


def _calibrated_hidden_scale(arch):
    """A requant scale for the MLP hidden activation, calibrated (margin
    1.25) on the port's full-precision prefill of a sample batch."""
    _, tcfg, _, tparams = _model(arch)
    seen = []
    orig = ops.matmul

    def spy(a, b, *args, **kwargs):
        out = orig(a, b, *args, **kwargs)
        if kwargs.get("epilogue") and kwargs["epilogue"][0] == "silu":
            seen.append(out)
        return out

    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab, (2, 16)))
    tlayers.ops.matmul = spy
    try:
        tapi.prefill(tcfg, tparams, {"tokens": toks}, MAX_LEN, torch.float32)
    finally:
        tlayers.ops.matmul = orig
    assert seen
    return float(tq.calibrate_scale(seen, "int8", margin=1.25))


def test_chatglm_requant_lane_matches_jax(monkeypatch):
    s = _calibrated_hidden_scale("chatglm3-6b")
    jpol, tpol = (jq.mlp_q8_policy(moe=False, requant_scale=s),
                  tq.mlp_q8_policy(moe=False, requant_scale=s))
    seen = []
    orig = ops.matmul

    def spy(a, b, *args, **kwargs):
        seen.append(a)
        return orig(a, b, *args, **kwargs)

    monkeypatch.setattr(tlayers.ops, "matmul", spy)
    _greedy_both(monkeypatch, "chatglm3-6b", jpol, tpol, seed=4)
    # The down GEMM took the hidden activation pre-quantized, on the grid of s.
    pre = [a for a in seen if hasattr(a, "q")]
    assert pre and all(a.q.dtype == torch.int8 and float(a.scale) == np.float32(s)
                       for a in pre)


def test_deepseek_under_moe_q8_policy_matches_jax_with_identical_routing(monkeypatch):
    j_idx, t_idx = [], []
    for module, sink in ((jmoe, j_idx), (tmoe, t_idx)):
        for name in ("_dispatch_onehot", "_dispatch_sort"):
            orig = getattr(module, name)

            def rec(params, xg, vg, ig, n_experts, capacity, backend=None, _o=orig, _s=sink):
                _s.append(np.asarray(ig))
                return _o(params, xg, vg, ig, n_experts, capacity, backend)

            monkeypatch.setattr(module, name, rec)
    pol = dict(rules={"moe": "q8"}, name="moe-q8")
    _greedy_both(monkeypatch, "deepseek-moe-16b", jq.PrecisionPolicy(**pol),
                 tq.PrecisionPolicy(**pol), seed=5)
    assert len(j_idx) == len(t_idx) == DECODE_STEPS + 1
    for j, t in zip(j_idx, t_idx):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("arch,policy,per_layer", [
    ("chatglm3-6b", tq.mlp_q8_policy(), {"torch": (4, 0), "torch_q8": (3, 0)}),
    ("deepseek-moe-16b", tq.PrecisionPolicy(rules={"moe": "q8"}),
     {"torch": (5, 0), "torch_q8": (3, 3)}),
], ids=["chatglm3-6b", "deepseek-moe-16b"])
def test_policy_routes_each_role_to_its_backend(arch, policy, per_layer):
    _, tcfg, _, tparams = _model(arch)
    ops.reset_counts()
    tapi.prefill(tcfg, tparams, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, 8,
                 backend=policy)
    for name, (dense, grouped) in per_layer.items():
        be = ops.backend(name)
        assert (be.calls, be.grouped_calls) == (dense * tcfg.n_layers, grouped * tcfg.n_layers)
    assert ops.backend("cuda").calls == ops.backend("cuda_q8").calls == 0
