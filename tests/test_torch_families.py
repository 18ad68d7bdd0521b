"""The six families the port serves and trains besides chatglm3-6b and
deepseek-moe-16b, against the JAX reference on the CPU, at ``.reduced()``
widths with fp32 parameters:

* stablelm-12b: the parallel block (attention and MLP read one LayerNorm'd
  input and share one residual stream), LayerNorm with bias;
* gemma2-9b: the ``(attn_local, attn)`` period, the local layers' sliding
  window (16 at reduced width, so the 20-40-token prompts here cross it),
  attention and final-logit soft-capping, the tied table;
* qwen2.5-32b: QKV bias on the GEMM's C preload;
* grok-1-314b: 8 experts top-2 with no shared expert (dropless at reduced
  width, and with capacity), ``grad_accum=8`` and bf16 AdamW moments;
* jamba-v0.1-52b: the hybrid period of mamba mixers (their conv window and
  ssm state in the caches) with MLP and MoE blocks and one attention layer;
* xlstm-125m: alternating sLSTM and mLSTM mixers with no FFN, their states
  in the caches.

Parameters come from the JAX package's ``init_params`` and are carried over
by ``repro_torch.convert.params_from_numpy``; both sides get the same numpy
tokens. Logits must agree within ``1e-4 * max(1, max|logits|)`` (only the
order of fp32 sums differs), greedy tokens and the engines' outputs and
counters must be identical, train-step losses within ``1e-4 * max(1,
|loss|)`` (``tests/test_torch_train.py``'s tolerance), checkpoints bit for
bit. The attention core's window and soft-cap alone are held against the
reference's functions in ``tests/test_torch_attention_window.py``.
"""

import contextlib
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import quant as jq
from repro.configs import get_config as j_get_config
from repro.data import MarkovLMDataset as JMarkov
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.tune import capture as j_capture
from repro_torch import checkpoint as tckpt
from repro_torch import quant as tq
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import MarkovLMDataset, make_batch_fn
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import OptState
from repro_torch.train import TrainLoopConfig, train
from repro_torch.train import loop as tloop
from repro_torch.tree import leaves, map_leaves
from repro_torch.tune import capture as t_capture

FAMILIES = ["stablelm-12b", "gemma2-9b", "qwen2.5-32b", "grok-1-314b", "jamba-v0.1-52b",
            "xlstm-125m"]
MAX_LEN = 48
PROMPT = 30  # past the reduced gemma2's window of 16
DECODE_STEPS = 8


@pytest.fixture(autouse=True)
def _few_threads():
    # Two torch threads, as the other model tests: the reduced models'
    # steps are mostly thread synchronisation at 8.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(arch, **fields):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **fields)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), **fields)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _model(arch, n_layers=None):
    jcfg, tcfg = _configs(arch, **({"n_layers": n_layers} if n_layers else {}))
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, rel=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape)


# ---------------------------------------------------------------------------
# the features each family adds
# ---------------------------------------------------------------------------


def test_reduced_configs_carry_the_features_under_test():
    cfgs = {arch: t_get_config(arch).reduced() for arch in FAMILIES}
    assert cfgs["stablelm-12b"].parallel_block and cfgs["stablelm-12b"].norm == "layernorm"
    g = cfgs["gemma2-9b"]
    assert [bd.mixer for bd in g.pattern] == ["attn_local", "attn"]
    assert (g.window, g.attn_softcap, g.final_softcap, g.tie_embeddings) == (16, 50.0, 30.0, True)
    assert cfgs["qwen2.5-32b"].qkv_bias
    moe = cfgs["grok-1-314b"].moe
    assert (moe.n_experts, moe.top_k, moe.n_shared) == (4, 2, 0)
    full = t_get_config("grok-1-314b")
    assert (full.grad_accum, full.moment_dtype) == (8, "bfloat16")
    j = cfgs["jamba-v0.1-52b"]
    assert [(bd.mixer, bd.ffn) for bd in j.pattern].count(("attn", "mlp")) == 1
    assert {bd.ffn for bd in j.pattern} == {"mlp", "moe"} and j.mamba is not None
    assert (j.n_layers, j.scan_chunk, j.moe.dropless) == (8, 8, True)
    x = cfgs["xlstm-125m"]
    assert [(bd.mixer, bd.ffn) for bd in x.pattern] == [("slstm", "none"), ("mlstm", "none")]


def test_parallel_block_carries_norm_ffn_unused():
    """stablelm's ``norm_ffn`` is drawn and carried, as in the reference,
    but the block reads ``norm_mixer``'s output only: changing it changes
    no logit."""
    _, tcfg, _, tparams = _model("stablelm-12b")
    toks = torch.from_numpy(_tokens((1, 12), seed=9))
    want, _ = tapi.prefill(tcfg, tparams, {"tokens": toks}, 16, torch.float32)
    moved = dict(tparams, blocks=[dict(b, norm_ffn={"scale": b["norm_ffn"]["scale"] * 3,
                                                    "bias": b["norm_ffn"]["bias"] + 1})
                                  for b in tparams["blocks"]])
    got, _ = tapi.prefill(tcfg, moved, {"tokens": toks}, 16, torch.float32)
    assert "bias" in tparams["blocks"][0]["norm_ffn"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_layers_follow_the_period_in_order():
    """gemma2 at 2 periods: layer ``i`` is ``pattern[i % 2]``, and the
    converter, ``params_to_numpy`` and the port's own init keep the
    reference's period-major order."""
    jcfg, tcfg, jparams, tparams = _model("gemma2-9b", 4)
    tree = jax.tree.map(np.asarray, jparams)
    for layer in range(4):
        pos, period = layer % 2, layer // 2
        np.testing.assert_array_equal(tparams["blocks"][layer]["attn"]["wq"]["w"].numpy(),
                                      tree["blocks"][pos]["attn"]["wq"]["w"][period])
    back = params_to_numpy(tcfg, tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, y)
    drawn = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [sorted(b) for b in drawn["blocks"]] == [sorted(b) for b in tparams["blocks"]]


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in FAMILIES] + [("gemma2-9b", 4)],
                         ids=FAMILIES + ["gemma2-9b-2-periods"])
def test_prefill_and_decode_match_jax_greedy_for_8_steps(arch, n_layers):
    jcfg, tcfg, jparams, tparams = _model(arch, n_layers)
    toks = _tokens((2, PROMPT))
    prefill = jax.jit(functools.partial(japi.prefill, jcfg, max_len=MAX_LEN,
                                        cache_dtype=jnp.float32, backend="xla"))
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend="xla"))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                          torch.float32)
    for i in range(DECODE_STEPS + 1):
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        if i == DECODE_STEPS:
            break
        jl, jc = decode(jparams, jnp.asarray(jtok, jnp.int32), jc, jnp.int32(PROMPT + i))
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, PROMPT + i)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_pallas_kernel_in_interpret_mode(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = _tokens((1, 20), seed=1)
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, 32,
                          jnp.float32, backend="pallas_interpret")
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 32, torch.float32)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    jl, _ = japi.decode(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(20),
                        backend="pallas_interpret")
    tl, _ = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, 20)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["gemma2-9b", "stablelm-12b"])
def test_bucketed_prefill_and_slot_decode_match_jax(arch):
    """Right-padded rows past the window, then per-slot decode steps."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    lengths = np.array([5, 32, 19, 24])
    toks = _tokens((4, 32), seed=2)
    jl, jc = jax.jit(functools.partial(japi.prefill_bucketed, jcfg, cache_dtype=jnp.float32))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lengths, jnp.int32))
    tl, tc = tapi.prefill_bucketed(tcfg, tparams, torch.from_numpy(toks),
                                   torch.from_numpy(lengths), torch.float32)
    _close(tl, jl)
    pad = MAX_LEN - toks.shape[1]
    jc = tuple(c._replace(k=jnp.pad(c.k, ((0, 0), (0, 0), (0, pad), (0, 0))),
                          v=jnp.pad(c.v, ((0, 0), (0, 0), (0, pad), (0, 0)))) for c in jc)
    for c in tc:
        c.k = torch.nn.functional.pad(c.k, (0, 0, 0, pad))
        c.v = torch.nn.functional.pad(c.v, (0, 0, 0, pad))
    pos = lengths.copy()
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    decode_at = jax.jit(functools.partial(japi.decode_at, jcfg))
    for _ in range(4):
        jl, jc = decode_at(jparams, jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tapi.decode_at(tcfg, tparams, torch.from_numpy(tok), tc, torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1)[:, None].numpy(), tok)
        pos = pos + 1


# ---------------------------------------------------------------------------
# parameter counts, shape harvest, and the periods the port takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_parameter_counts_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    assert tapi.param_count(tcfg) == japi.param_count(jcfg)
    assert tapi.active_param_count(tcfg) == japi.active_param_count(jcfg)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_init_state_matches_the_reference_layer_by_layer(arch):
    """One cache a layer, of the reference's kind, shapes, dtypes and
    values (mamba's conv window in the cache dtype, the rest fp32, the
    xLSTM stabilisers at -1e30); the reference stacks each pattern
    position over periods."""
    jcfg, tcfg = _configs(arch, n_layers=2 * len(t_get_config(arch).reduced().pattern))
    want = japi.init_state(jcfg, 3, 10, jnp.bfloat16)
    got = tapi.init_state(tcfg, 3, 10, torch.bfloat16, device="cpu")
    assert len(got) == tcfg.n_layers
    for layer, c in enumerate(got):
        pos, period = layer % len(tcfg.pattern), layer // len(tcfg.pattern)
        w = want[pos]
        assert type(c).__name__ == type(w).__name__
        for f in dataclasses.fields(c):
            x, y = getattr(c, f.name), np.asarray(getattr(w, f.name)[period])
            if f.name == "length":
                assert x == 0 and int(y) == 0
                continue
            assert tuple(x.shape) == y.shape and str(x.dtype)[6:] == str(y.dtype), (layer, f.name)
            np.testing.assert_array_equal(x.float().numpy(), y.astype(np.float32))


def test_converter_round_trips_jambas_period_of_8_with_mixed_dtypes():
    """jamba at 2 periods in bf16: the converter unstacks the reference's 8
    stacks period-major, keeps ``A_log``, ``D``, ``dt_bias`` and the norms
    in fp32 beside the bf16 leaves, and ``params_to_numpy`` restacks them
    (bf16 widened to fp32) leaf for leaf."""
    jcfg, tcfg = _configs("jamba-v0.1-52b", n_layers=16, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(japi.init_params, jcfg))(
        jax.random.key(1)))
    tparams = params_from_numpy(tcfg, tree, "cpu")
    assert len(tparams["blocks"]) == 16
    m = tparams["blocks"][9]["mamba"]
    assert {k: str(v.dtype)[6:] for k, v in m.items()} == {
        k: str(v.dtype) for k, v in tree["blocks"][1]["mamba"].items()}
    assert m["in_proj"].dtype == torch.bfloat16 and m["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(m["A_log"].numpy(), tree["blocks"][1]["mamba"]["A_log"][1])
    back = params_to_numpy(tcfg, tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))
    drawn = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert [sorted(b) for b in drawn["blocks"]] == [sorted(b) for b in tparams["blocks"]]
    assert _dtypes(drawn) == _dtypes(tparams)


def _dtypes(tree, path=""):
    """Each leaf's dtype by its path in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _dtypes(sub, f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _dtypes(sub, f"{path}[{i}]").items()}
    return {path: tree.dtype}


@pytest.mark.parametrize("arch", FAMILIES)
def test_harvest_equals_the_reference_at_published_widths(arch):
    got = t_capture.harvest_model_shapes(arch, batch=2, seq=64)
    want = j_capture.harvest_model_shapes(arch, batch=2, seq=64)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert got


def _blocks(*pairs):
    from repro_torch.configs.base import BlockDef

    return tuple(BlockDef(mixer, ffn) for mixer, ffn in pairs)


@pytest.mark.parametrize("arch, pattern, parallel, ported", [
    ("gemma2-9b", (("attn_local", "mlp"), ("attn", "mlp")), False, True),
    ("stablelm-12b", (("attn", "mlp"),), True, True),
    ("grok-1-314b", (("attn", "moe"),), False, True),
    ("grok-1-314b", (("attn_local", "moe"),), False, False),
    ("grok-1-314b", (("attn_local", "moe"), ("attn", "moe")), False, False),
    ("grok-1-314b", (("attn", "moe"),), True, False),
    ("gemma2-9b", (("attn_local", "moe"), ("attn", "mlp")), False, False),
    ("jamba-v0.1-52b", (("mamba", "moe"), ("attn", "mlp")), False, True),
    ("jamba-v0.1-52b", (("mamba", "mlp"),), False, False),
    ("jamba-v0.1-52b", (("attn", "moe"), ("mamba", "mlp")), False, False),
    ("xlstm-125m", (("mlstm", "none"),), False, True),
    ("xlstm-125m", (("mlstm", "mlp"),), False, False),
])
def test_check_supported_takes_only_the_ported_blocks(arch, pattern, parallel, ported):
    """Dense periods take global and sliding-window attention, MoE periods
    global attention only, hybrid periods mamba blocks with an MLP or MoE
    and attention with an MLP, ssm periods the xLSTM mixers without an FFN;
    an MoE spec goes with MoE blocks, and only a dense block runs in
    parallel."""
    from repro_torch.models.transformer import check_supported

    cfg = dataclasses.replace(t_get_config(arch).reduced(), pattern=_blocks(*pattern),
                              n_layers=len(pattern), parallel_block=parallel)
    if ported:
        check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError):
            check_supported(cfg)


# ---------------------------------------------------------------------------
# under a q8 policy
# ---------------------------------------------------------------------------


def _greedy_both(arch, jpol, tpol, seed):
    """Prefill 2 prompts of ``PROMPT`` tokens, then DECODE_STEPS greedy
    steps on each side under the policies, holding logits and tokens. The
    JAX side runs eagerly, as ``tests/test_torch_q8_model.py`` runs it."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = _tokens((2, PROMPT), seed=seed)
    with jax.disable_jit():
        jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, MAX_LEN,
                              jnp.float32, backend=jpol)
        tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                              torch.float32, backend=tpol)
        for i in range(DECODE_STEPS + 1):
            _close(tl, jl)
            jtok = np.asarray(jnp.argmax(jl, -1))[:, None]
            ttok = torch.argmax(tl, -1)[:, None]
            np.testing.assert_array_equal(ttok.numpy(), jtok)
            if i == DECODE_STEPS:
                break
            jl, jc = japi.decode(jcfg, jparams, jnp.asarray(jtok, jnp.int32), jc,
                                 jnp.int32(PROMPT + i), backend=jpol)
            tl, tc = tapi.decode(tcfg, tparams, ttok, tc, PROMPT + i, backend=tpol)


def test_qwen_under_mlp_q8_policy_matches_jax():
    _greedy_both("qwen2.5-32b", jq.mlp_q8_policy(), tq.mlp_q8_policy(), seed=3)


def test_jamba_under_moe_and_mixer_q8_policy_matches_jax():
    """The experts on the grouped int8 GEMM and the mamba projections on the
    dense one; the decode step's ``x_proj`` and ``dt_proj`` on the default
    backend, as the reference's."""
    pol = dict(rules={"moe": "q8", "mixer": "q8"}, name="moe-mixer-q8")
    _greedy_both("jamba-v0.1-52b", jq.PrecisionPolicy(**pol), tq.PrecisionPolicy(**pol), seed=7)


def test_grok_under_moe_q8_policy_matches_jax_with_identical_routing(monkeypatch):
    j_idx, t_idx = [], []
    for module, sink in ((jmoe, j_idx), (tmoe, t_idx)):
        for name in ("_dispatch_onehot", "_dispatch_sort"):
            orig = getattr(module, name)

            def rec(params, xg, vg, ig, n_experts, capacity, backend=None, _o=orig, _s=sink):
                _s.append(np.asarray(ig))
                return _o(params, xg, vg, ig, n_experts, capacity, backend)

            monkeypatch.setattr(module, name, rec)
    pol = dict(rules={"moe": "q8"}, name="moe-q8")
    _greedy_both("grok-1-314b", jq.PrecisionPolicy(**pol), tq.PrecisionPolicy(**pol), seed=5)
    assert len(j_idx) == len(t_idx) == DECODE_STEPS + 1
    for j, t in zip(j_idx, t_idx):
        np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _train_cfgs(arch):
    """The reduced config, with grok's ``grad_accum`` and moment dtype
    restored (``.reduced()`` resets them)."""
    full = t_get_config(arch)
    return _configs(arch, grad_accum=full.grad_accum, moment_dtype=full.moment_dtype)


# jamba's gradient norm after the first update: its dt_bias leaves start at
# zero and hold gradient elements near 1e-8, where AdamW's g / (|g| + eps)
# turns fp32 rounding into a visible change of the update; the first step's
# gradients agree with the reference's to 1e-4 of each leaf's largest (and
# their norm to 1e-6), and the losses of all 3 steps to 1e-4. With eps
# raised above those gradients the later norms agree to 1e-4 too
# (test_jamba_later_grad_norms_agree_once_eps_is_above_dt_bias_gradients).
LATER_GRAD_NORM_REL = {"jamba-v0.1-52b": 1e-3}


def _train_3_steps(arch, **opt_overrides):
    """The reference's and the port's train steps, 3 of them from the same
    parameters and batches: yields each step's (port, reference) metrics."""
    jcfg, tcfg = _train_cfgs(arch)
    params = jax.tree.map(np.asarray, _model(arch)[2])
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, moment_dtype=tcfg.moment_dtype,
               **opt_overrides)
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**opt), donate=False)
    tstep = tloop.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(tcfg, params, "cpu")
    js = jadamw.init_opt_state(jp, jadamw.AdamWConfig(**opt))
    ts = tadamw.init_opt_state(tp, tadamw.AdamWConfig(**opt))
    assert {x.dtype for x in leaves(ts.mu)} == {getattr(torch, tcfg.moment_dtype)}
    ds = JMarkov(tcfg.vocab, 24, 8, seed=2)  # 8 rows: one a microbatch for grok
    for step in range(3):
        host = ds.batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in host.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v.astype(np.int64))
                                    for k, v in host.items()})
        yield tm, jm


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_losses_match_jax_over_3_steps(arch):
    for step, (tm, jm) in enumerate(_train_3_steps(arch)):
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"],
               rel=LATER_GRAD_NORM_REL.get(arch, 1e-4) if step else 1e-4)


def test_jamba_later_grad_norms_agree_once_eps_is_above_dt_bias_gradients():
    """LATER_GRAD_NORM_REL's cause: with AdamW's eps at 1e-6, above
    dt_bias's gradients near 1e-8, jamba's losses and gradient norms of all
    3 steps agree to 1e-4."""
    for tm, jm in _train_3_steps("jamba-v0.1-52b", eps=1e-6):
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"])


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_updates_a_leaf_in_slices_bit_for_bit(monkeypatch, moment_dtype):
    """``apply_updates`` works through each leaf in flat slices (the clip
    scale inside them), so that grok's expert leaves need no full-size fp32
    temporaries; slices of 7 elements give the whole-leaf update's bits."""
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(3, 5, 9, generator=gen).to(torch.bfloat16),
              "s": torch.randn(11, generator=gen), "t": torch.randn(4, 4, generator=gen).t()}
    grads = map_leaves(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype) * 10, params)
    cfg = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, moment_dtype=moment_dtype)

    def run(slice_elems):
        monkeypatch.setattr(tadamw, "UPDATE_SLICE", slice_elems)
        p = map_leaves(lambda x: x.clone(), params)
        state = tadamw.init_opt_state(p, cfg)
        for _ in range(2):
            p, state, metrics = tadamw.apply_updates(p, grads, state, cfg)
        return p, state, metrics

    (p1, s1, m1), (p2, s2, m2) = run(1 << 26), run(7)
    assert float(m1["grad_norm"]) > cfg.clip_norm  # the clip scale is applied
    for x, y in zip(leaves((p1, s1.mu, s1.nu)), leaves((p2, s2.mu, s2.nu))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)], ids=["bf16", "fp32-bf16"])
def test_backward_gemm_operands_are_contiguous_casts(dtypes):
    """The backward GEMMs hand the kernels contiguous operands in one dtype,
    the transposed weight cast and laid out in one copy; the product is the
    plain one's."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 5, generator=gen).to(dtypes[0])
    w = torch.randn(2, 4, 5, generator=gen).to(dtypes[1]).transpose(-1, -2)
    seen = []

    def member(a, b, c=None, *, out_dtype=None):
        seen.append((a.is_contiguous(), b.is_contiguous(), a.dtype, b.dtype))
        return torch.matmul(a.float(), b.float()).to(out_dtype)

    got = ops._bwd_gemm(member, x, w, torch.float32)
    assert seen == [(True, True, dtypes[0], dtypes[0])]
    torch.testing.assert_close(got, torch.matmul(x.float(), w.float()), rtol=0, atol=0)


@pytest.mark.parametrize("before", ["", "expandable_segments:False", "expandable_segments:True"])
def test_training_grows_segments_in_place_and_restores_the_setting(monkeypatch, before):
    """On a CUDA device the allocator grows its segments in place inside
    the block and finds the setting it had on entry after it; off CUDA
    nothing changes. Only the allocator's settings string is read and set
    here: no CUDA context is made."""
    seen = {"now": before}
    monkeypatch.setattr(tloop, "_allocator_settings", lambda: seen["now"])
    monkeypatch.setattr(tloop, "_set_allocator", lambda s: seen.update(now=s))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    with tloop.expandable_segments(torch.device("cpu")):
        assert seen["now"] == before
    with tloop.expandable_segments(torch.device("cuda", 0)):
        assert seen["now"] == "expandable_segments:True"
    assert seen["now"] == (before or "expandable_segments:False")
    with pytest.raises(RuntimeError):
        with tloop.expandable_segments("cuda"):
            raise RuntimeError("a failing step")
    assert seen["now"] == (before or "expandable_segments:False")


def test_train_runs_under_expandable_segments(monkeypatch):
    """The loop enters the allocator setting for the parameters' device."""
    entered = []

    @contextlib.contextmanager
    def spy(device):
        entered.append(torch.device(device).type)
        yield

    monkeypatch.setattr(tloop, "expandable_segments", spy)
    cfg = t_get_config("gemma2-9b").reduced()
    batch_fn = make_batch_fn(MarkovLMDataset(cfg.vocab, 8, 2, seed=0), "cpu")
    res = train(cfg, tadamw.AdamWConfig(warmup_steps=1, total_steps=1),
                TrainLoopConfig(total_steps=1, log_every=0), batch_fn, device="cpu",
                log=lambda msg: None)
    assert entered == ["cpu"] and len(res.losses) == 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


CKPT_FAMILIES = ["gemma2-9b", "grok-1-314b"]


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _assert_trees_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("arch", CKPT_FAMILIES)
def test_the_reference_reads_a_model_state_the_port_saves(tmp_path, arch):
    """gemma2 at 2 periods (the stacking's order shows) and grok with its
    bf16 moments. The reference restores the parameters (and gemma2's fp32
    moments) leaf for leaf. Its ``restore`` cannot read bf16 leaves
    (ROADMAP §C), so grok's moment files are held byte for byte against the
    reference's ``save`` of the same state instead."""
    jcfg, tcfg = _train_cfgs(arch)
    jcfg, tcfg = (dataclasses.replace(c, n_layers=2 * len(c.pattern)) for c in (jcfg, tcfg))
    jparams = jax.tree.map(np.asarray, jax.jit(functools.partial(japi.init_params, jcfg))(
        jax.random.key(0)))
    tp = params_from_numpy(tcfg, jparams, "cpu")
    dt = getattr(torch, tcfg.moment_dtype)
    gen = torch.Generator().manual_seed(3)
    state = OptState(torch.tensor(17, dtype=torch.int32),
                     map_leaves(lambda p: torch.randn(p.shape, generator=gen).to(dt), tp),
                     map_leaves(lambda p: torch.rand(p.shape, generator=gen).to(dt), tp))
    tckpt.save(str(tmp_path / "t"), 17, {"params": tp, "opt": state}, period=len(tcfg.pattern))
    params_like = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    fp32_moments = tcfg.moment_dtype == "float32"
    like = {"params": params_like}
    if fp32_moments:
        like["opt"] = jax.eval_shape(
            lambda: jadamw.init_opt_state(params_like, jadamw.AdamWConfig()))
    back = jckpt.restore(str(tmp_path / "t"), 17, like=like)
    want = {"params": params_to_numpy(tcfg, tp)}
    got = {"params": back["params"]}
    if fp32_moments:
        assert int(back["opt"].step) == 17
        want.update(mu=params_to_numpy(tcfg, state.mu), nu=params_to_numpy(tcfg, state.nu))
        got.update(mu=back["opt"].mu, nu=back["opt"].nu)
    for key in want:
        assert jax.tree.structure(got[key]) == jax.tree.structure(want[key])
        for x, y in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key])):
            np.testing.assert_array_equal(np.asarray(x), y)
    if not fp32_moments:
        bf16 = lambda tree: jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16),  # noqa: E731
                                         params_to_numpy(tcfg, tree))
        jstate = jadamw.OptState(np.asarray(17, np.int32), bf16(state.mu), bf16(state.nu))
        jckpt.save(str(tmp_path / "j"), 17, {"params": jparams, "opt": jstate})
        jd, td = tmp_path / "j" / "step_00000017", tmp_path / "t" / "step_00000017"
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
        for name in os.listdir(jd):
            assert (jd / name).read_bytes() == (td / name).read_bytes(), name
        manifest = json.loads((td / "manifest.json").read_text())
        assert {e["dtype"] for e in manifest["leaves"] if "/.mu/" in e["path"]} == {"bfloat16"}
    again = tckpt.restore(str(tmp_path / "t"), 17, {"params": tp, "opt": state}, device="cpu",
                          period=len(tcfg.pattern))
    _assert_trees_equal(again, {"params": tp, "opt": state})


def _loop(tcfg, total, ckpt_dir=None, fail_at_step=None):
    ds = MarkovLMDataset(vocab=tcfg.vocab, seq_len=16, batch=8, seed=0)
    opt = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=total)
    loop = TrainLoopConfig(total_steps=total, ckpt_every=3, ckpt_dir=ckpt_dir, log_every=0,
                           fail_at_step=fail_at_step)
    return train(tcfg, opt, loop, make_batch_fn(ds, "cpu"), device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("arch", CKPT_FAMILIES)
def test_resume_after_a_failure_is_bitwise(tmp_path, arch):
    """8 steps, a checkpoint every 3, a failure at step 7: the run resumed
    from step 6 ends with the uninterrupted run's parameters and moments
    (grok's in bf16) bit for bit, and its losses."""
    _, tcfg = _train_cfgs(arch)
    whole = _loop(tcfg, 8)
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        _loop(tcfg, 8, str(tmp_path), fail_at_step=7)
    assert tckpt.latest_step(str(tmp_path)) == 6
    res = _loop(tcfg, 8, str(tmp_path))
    assert res.resumed_from == 6 and res.losses == whole.losses[6:]
    assert {x.dtype for x in leaves(res.opt_state.mu)} == {getattr(torch, tcfg.moment_dtype)}
    _assert_trees_equal({"p": res.params, "o": res.opt_state},
                        {"p": whole.params, "o": whole.opt_state})


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def test_static_engine_greedy_tokens_match_jax():
    from repro.serve import ServeEngine as JServe
    from repro_torch.serve import ServeEngine

    jcfg, tcfg, jparams, tparams = _model("gemma2-9b")
    toks = _tokens((3, 20), seed=4)
    want = JServe(cfg=jcfg, params=jparams, max_len=40, cache_dtype=jnp.float32).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, 16)
    got = ServeEngine(cfg=tcfg, params=tparams, max_len=40, cache_dtype=torch.float32).generate(
        {"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
