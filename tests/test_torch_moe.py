"""The port's MoE model (deepseek-moe-16b) against the JAX reference, on the CPU.

Parameters come from the JAX package's ``init_params`` (reduced config, fp32
parameters) and are carried over by ``params_from_numpy``; inputs are numpy
draws from fixed seeds. Routing must be identical: the same top-k expert
indices and the same kept (not capacity-dropped) assignments. Outputs agree
within ``1e-4 * max(1, max|y|)`` (only the order of fp32 sums differs), the
load-balancing loss within 1e-6, greedy tokens and serving counters exactly.
The JAX side runs ``backend="xla"``, and once ``"pallas_interpret"`` (its
Pallas GEMM kernels, the grouped one included, in interpret mode).
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
from repro.models import moe as jmoe
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import poisson_trace as j_poisson_trace
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.serve import ContinuousEngine, poisson_trace

ARCH = "deepseek-moe-16b"
MAX_LEN = 32
TRACE = dict(seed=5, vocab=256, prompt_lens=(5, 9, 17), gen_lens=(3, 6, 9),
             mean_interarrival=1.5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _monolithic_reference(monkeypatch):
    # The reference engine reads these knobs from the environment; the port
    # serves the monolithic path only.
    for var in ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS",
                "REPRO_SLO_ITL_MS"):
        monkeypatch.delenv(var, raising=False)


def _configs(**moe):
    """The reduced config on both sides (dropless, as ``reduced()`` makes it,
    unless ``moe`` replaces MoE fields)."""
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, tcfg = _configs()
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jparams, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


def _layer0(jparams, tparams):
    return jax.tree.map(lambda x: x[0], jparams["blocks"][0]["moe"]), tparams["blocks"][0]["moe"]


def _close(got, want, rel=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _record_dispatch(monkeypatch, module, sink):
    """Wrap ``module``'s two dispatch functions to record (top_idx, capacity)."""
    for name in ("_dispatch_onehot", "_dispatch_sort"):
        orig = getattr(module, name)

        def rec(params, xg, vg, ig, n_experts, capacity, backend=None, _orig=orig):
            sink.append((ig, capacity))
            return _orig(params, xg, vg, ig, n_experts, capacity, backend)

        monkeypatch.setattr(module, name, rec)


def _moe_kwargs(cfg):
    m = cfg.moe
    return dict(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
                dispatch=m.dispatch, group_size=m.group_size, dropless=m.dropless)


def _moe_both(monkeypatch, jp, tp, x, cfg):
    """One moe_apply on each side: (jy, jaux, j_routing), (ty, taux, t_routing)."""
    j_rec, t_rec = [], []
    _record_dispatch(monkeypatch, jmoe, j_rec)
    _record_dispatch(monkeypatch, tmoe, t_rec)
    jy, ja = jmoe.moe_apply(jp, jnp.asarray(x), backend="xla", **_moe_kwargs(cfg))
    ty, ta = tmoe.moe_apply(tp, torch.from_numpy(x), **_moe_kwargs(cfg))
    return (jy, ja, j_rec), (ty, ta, t_rec)


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_apply_matches_jax_with_identical_routing(monkeypatch, dispatch, dropless):
    jcfg, tcfg = _configs(dispatch=dispatch, dropless=dropless, group_size=16)
    jp, tp = _layer0(*_params())
    x = np.random.default_rng(1).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    (jy, ja, j_rec), (ty, ta, t_rec) = _moe_both(monkeypatch, jp, tp, x, tcfg)
    (j_idx, j_cap), (t_idx, t_cap) = j_rec[0], t_rec[0]
    assert j_cap == t_cap and t_idx.dtype == torch.int64
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_keep = np.asarray(jmoe._positions_in_expert(j_idx, 4)) < j_cap
    t_keep = (tmoe._positions_in_expert(t_idx, 4) < t_cap).numpy()
    np.testing.assert_array_equal(t_keep, j_keep)
    assert t_keep.all() == dropless  # the capacity case does drop
    _close(ty, jy)
    assert abs(float(ta) - float(ja)) <= 1e-6


@pytest.mark.parametrize("tie", ["all-experts", "two-experts"])
def test_tied_gates_route_to_the_lower_expert_index(monkeypatch, tie):
    jcfg, tcfg = _configs(dropless=False)
    jp, tp = _layer0(*_params())
    router = np.asarray(jp["router"]).copy()
    if tie == "all-experts":
        router[:] = router[:, :1]
    else:
        router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(2).standard_normal((1, 16, tcfg.d_model)).astype(np.float32)
    (jy, _, j_rec), (ty, _, t_rec) = _moe_both(monkeypatch, jp, tp, x, tcfg)
    j_idx, t_idx = np.asarray(j_rec[0][0]), t_rec[0][0].numpy()
    np.testing.assert_array_equal(t_idx, j_idx)
    if tie == "all-experts":
        assert (t_idx == [0, 1]).all()
    else:
        assert not ((t_idx[..., 0] == 2) | ((t_idx[..., 1] == 2) & (t_idx[..., 0] != 1))).any()
    _close(ty, jy)


def test_moe_forward_runs_three_grouped_and_eight_dense_gemms_per_layer():
    jcfg, tcfg = _configs()
    _, tp = _params()
    ops.reset_counts()
    tapi.prefill(tcfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, 8)
    be = ops.backend("torch")
    assert (be.grouped_calls, be.calls) == (3 * tcfg.n_layers, 8 * tcfg.n_layers)


def test_prefill_and_decode_match_jax_greedy_for_8_steps():
    jcfg, tcfg = _configs()
    jparams, tparams = _params()
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 11))
    prefill = jax.jit(functools.partial(japi.prefill, jcfg, backend="xla",
                                        max_len=MAX_LEN, cache_dtype=jnp.float32))
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend="xla"))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, torch.float32)
    _close(tl, jl)
    for i in range(8):
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = decode(jparams, jnp.asarray(jtok, jnp.int32), jc, jnp.int32(11 + i))
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, 11 + i)
        _close(tl, jl)
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), np.asarray(jnp.argmax(jl, -1)))


def test_prefill_and_decode_match_the_pallas_kernels_in_interpret_mode():
    jcfg, tcfg = _configs()
    jparams, tparams = _params()
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (1, 9))
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_LEN, jnp.float32, backend="pallas_interpret")
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, torch.float32)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    np.testing.assert_array_equal(torch.argmax(tl, -1)[:, None].numpy(), tok)
    jl, _ = japi.decode(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(9),
                        backend="pallas_interpret")
    tl, _ = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, 9)
    _close(tl, jl)


@pytest.mark.parametrize("n_slots,dropless", [(2, True), (4, True), (4, False)],
                         ids=["2-slots", "4-slots", "4-slots-capacity"])
def test_continuous_engine_matches_jax(n_slots, dropless):
    jcfg, tcfg = _configs(dropless=dropless)
    jparams, tparams = _params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = JContinuous(cfg=jcfg, params=jparams, n_slots=n_slots, max_len=MAX_LEN,
                           cache_dtype=jnp.float32).serve(j_poisson_trace(8, **TRACE))
        got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=n_slots, max_len=MAX_LEN,
                               cache_dtype=torch.float32).serve(poisson_trace(8, **TRACE))
    assert got.outputs == want.outputs
    assert got.generated_tokens == want.generated_tokens
    assert got.decode_steps == want.decode_steps
    assert got.prefill_batches == want.prefill_batches
    assert got.mean_occupancy == want.mean_occupancy


def test_capacity_dropping_warns_on_both_sides():
    jcfg, tcfg = _configs(dropless=False)
    jparams, tparams = _params()
    with pytest.warns(RuntimeWarning, match="capacity-dropping MoE") as j_warn:
        JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=MAX_LEN)
    with pytest.warns(RuntimeWarning, match="capacity-dropping MoE") as t_warn:
        ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=MAX_LEN)
    assert str(t_warn[0].message) == str(j_warn[0].message)
    jcfg, tcfg = _configs()  # dropless: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=MAX_LEN)


def test_converter_carries_the_moe_block_per_layer():
    jcfg, tcfg = _configs()
    jcfg, tcfg = (dataclasses.replace(c, n_layers=2) for c in (jcfg, tcfg))
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(1))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tcfg, tree, "cpu")
    assert len(params["blocks"]) == 2
    for layer in range(2):
        got, src = params["blocks"][layer]["moe"], tree["blocks"][0]["moe"]
        for key in ("router", "w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(got[key].numpy(), src[key][layer])
        for key in ("w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(got["shared"][key].numpy(), src["shared"][key][layer])
    assert tuple(params["blocks"][1]["moe"]["w_down"].shape) == (4, 32, tcfg.d_model)


@pytest.mark.parametrize("arch", [ARCH, "chatglm3-6b"])
def test_parameter_counts_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tapi.active_param_count(tcfg) == japi.active_param_count(jcfg)


def test_port_draws_moe_parameters_and_serves_reduced_deepseek():
    _, tcfg = _configs()
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    moe = params["blocks"][0]["moe"]
    assert tuple(moe["w_gate"].shape) == (4, tcfg.d_model, 32)
    assert tuple(moe["shared"]["w_down"].shape) == (32, tcfg.d_model)
    report = ContinuousEngine(cfg=tcfg, params=params, n_slots=2, max_len=MAX_LEN).serve(
        poisson_trace(3, **TRACE))
    assert sorted(report.outputs) == [0, 1, 2]


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_launch_serve_runs_reduced_deepseek_on_the_cpu(engine):
    out = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--engine",
                             engine, "--n-requests", "3", "--gen", "4", "--prompt-len", "8"])
    assert out["arch"] == ARCH + "-reduced" and out["engine"] == engine
    assert out["tokens_per_sec"] > 0
