"""fp16 models on the port against the JAX reference, on the CPU, and the
two entry-point rules that come with them.

chatglm3-6b and deepseek-moe-16b, reduced, with ``param_dtype="float16"``
(the config field both packages read): parameters from the reference's
``init_params``, carried over by ``params_from_numpy``, the same numpy
tokens on both sides, K/V in bf16 (the reference launcher's rule for every
model that is not fp32). Prefill logits within ``2**-10 * max(1,
max|logits|)`` of the reference on ``xla`` and on ``pallas_interpret``,
then 8 greedy decode steps token for token, their logits within ``2**-8 *
max(1, max|logits|)``.

Every activation rounds to fp16 on both sides, and K/V to bf16, from fp32
values that differ in their last bits where the two packages sum in other
orders. On most rows nothing rounds the other way and the logits agree to
fp32 noise (under ``2**-20`` of their scale). On the others an element
rounds the other way and the row's logits move, by up to 4.2e-4 of their
scale at the prefill and 1.8e-3 at a later decode step over seeds 3 to 10
(the sweep below); the gaps above are 2.3x and 2.1x those.
The first such element found (chatglm3-6b, seed 3, row 0, token 7) is one
fp16 output of the first RMSNorm: XLA's fp32 mean of ``x*x`` over the 64
channels is one ulp away from torch's (and from the fp64 mean, which
torch's matches there), and ``y`` then rounds to the next fp16 value
(``test_an_fp16_row_moves_where_xla_and_torch_sum_a_norm_apart``).
``test_fp16_rows_agree_to_fp32_noise_and_the_controls_do_not`` holds the
share of rows that agree to fp32 noise, which a real fp16 fault leaves at
none: K/V kept in fp16 or the activations left in fp32. Run this file as
a script to sweep seeds (``PYTHONPATH=src:tests python
tests/test_torch_fp16_model.py 3 10``): it prints, per arch, seed and
variant, the largest gaps and the share of rows that agree.

Also: the serve launcher keeps K/V in the reference launcher's dtype (fp32
for an fp32 model, bf16 for every other), and ``make_batch_fn`` puts its
batches on ``cuda`` unless told otherwise, as every entry point of the port.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_launch
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import MarkovLMDataset, make_batch_fn
from repro_torch.launch import serve as t_launch
from repro_torch.models import api as tapi

MAX_LEN = 32
# Relative to max(1, max|logits|): the largest gap on any row, prefill and
# decode (the sweep's largest readings, 4.2e-4 and 1.8e-3, are 2.3x and 2.1x
# below), and a row that agrees to fp32 noise at every step.
PREFILL_GAP, DECODE_GAP, CLEAN_GAP = 2.0 ** -10, 2.0 ** -8, 2.0 ** -20
# The share of rows that must agree to fp32 noise (the sweep reads 0.375 to
# 0.875 on the port and 0 on both controls, over 8 rows and 8 steps).
CLEAN_ROWS = 0.25
VARIANTS = ("port", "kv_fp16", "fp32_act")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), param_dtype="float16")
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float16")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert tparams["blocks"][0]["norm_ffn"]["scale"].dtype == torch.float32
    assert tparams["embed"]["table"].dtype == torch.float16
    return jcfg, tcfg, jparams, tparams


def _close(got, want, ulp=PREFILL_GAP):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_fp16_prefill_and_decode_match_jax_greedy_for_8_steps(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 11))
    prefill = jax.jit(functools.partial(japi.prefill, jcfg, backend="xla", max_len=MAX_LEN,
                                        cache_dtype=jnp.bfloat16))
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend="xla"))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                          torch.bfloat16)
    assert tc[0].k.dtype == torch.bfloat16
    _close(tl, jl)
    for i in range(8):
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = decode(jparams, jnp.asarray(jtok, jnp.int32), jc, jnp.int32(11 + i))
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, 11 + i)
        _close(tl, jl, DECODE_GAP)
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), np.asarray(jnp.argmax(jl, -1)))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_fp16_prefill_and_decode_match_the_pallas_kernels_in_interpret_mode(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (1, 9))
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_LEN, jnp.bfloat16, backend="pallas_interpret")
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                          torch.bfloat16)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    np.testing.assert_array_equal(torch.argmax(tl, -1)[:, None].numpy(), tok)
    jl, _ = japi.decode(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(9),
                        backend="pallas_interpret")
    tl, _ = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, 9)
    _close(tl, jl, DECODE_GAP)


def _reference_run(arch, seed, batch, steps):
    """The reference's prefill logits, then ``steps`` greedy decode steps:
    the tokens it fed and the logits it gave at each step."""
    jcfg, tcfg, jparams, _ = _model(arch)
    toks = np.random.default_rng(seed).integers(0, tcfg.vocab, (batch, 11))
    prefill = jax.jit(functools.partial(japi.prefill, jcfg, backend="xla", max_len=MAX_LEN,
                                        cache_dtype=jnp.bfloat16))
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend="xla"))
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    logits, fed = [np.asarray(jl, np.float32)], []
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
        jl, jc = decode(jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(11 + i))
        fed.append(tok)
        logits.append(np.asarray(jl, np.float32))
    return toks, fed, logits


@functools.lru_cache(maxsize=None)
def _fp32_model(arch):
    """The fp16 model's weights in an fp32 model: no activation rounds to fp16."""
    jcfg, tcfg, jparams, _ = _model(arch)
    cfg = dataclasses.replace(tcfg, param_dtype="float32")
    return cfg, params_from_numpy(cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                    jparams), "cpu")


def _row_gaps(arch, ref, variant):
    """[steps + 1, batch]: each row's largest gap to the reference's logits
    over max(1, max|logits|), at the prefill and at each decode step fed
    the reference's tokens. ``variant``: ``port`` (the model as served: fp16
    weights and activations, bf16 K/V), ``kv_fp16`` (K/V kept in fp16),
    ``fp32_act`` (the same weights, activations in fp32)."""
    _, tcfg, _, tparams = _model(arch)
    kv = torch.float16 if variant == "kv_fp16" else torch.bfloat16
    if variant == "fp32_act":
        tcfg, tparams = _fp32_model(arch)
    toks, fed, logits = ref
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN, kv)
    out = [tl]
    for i, tok in enumerate(fed):
        tl, tc = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, 11 + i)
        out.append(tl)
    return np.stack([np.abs(t.float().numpy() - w).max(-1) / max(1.0, float(np.abs(w).max()))
                     for t, w in zip(out, logits)])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_fp16_rows_agree_to_fp32_noise_and_the_controls_do_not(arch):
    """8 rows, prefill and 8 decode steps fed the reference's tokens: every
    gap within PREFILL_GAP / DECODE_GAP, and at least CLEAN_ROWS of the rows
    within CLEAN_GAP at every step. Both controls, K/V in fp16 and
    activations in fp32, fail the second: none of their rows agrees to fp32
    noise. The first alone would not catch them: the fp32-activation control
    reads 3.9e-4 to 7.3e-4 at the prefill over the sweep's seeds."""
    ref = _reference_run(arch, 3, 8, 8)
    for variant in VARIANTS:
        gaps = _row_gaps(arch, ref, variant)
        clean = float((gaps.max(0) <= CLEAN_GAP).mean())
        if variant == "port":
            assert gaps[0].max() <= PREFILL_GAP and gaps[1:].max() <= DECODE_GAP
            assert clean >= CLEAN_ROWS, (variant, clean)
        else:
            assert clean < CLEAN_ROWS, (variant, clean)


def test_an_fp16_row_moves_where_xla_and_torch_sum_a_norm_apart():
    """The first such element, pinned: chatglm3-6b's first RMSNorm on the
    embedding rows of seed 3's tokens, the same fp16 values on both sides
    (the reference's layer under jit, the port's). XLA's fp32 mean of
    ``x*x`` is up to two ulps from torch's in most rows and one ulp off
    at row 0, token 7, where torch's is the fp64 mean rounded; of the
    2 x 11 x 64 fp16 outputs exactly one rounds the other way, there, by
    one fp16 ulp."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    _, tcfg, _, tparams = _model("chatglm3-6b")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 11))
    x = tparams["embed"]["table"][torch.from_numpy(toks)]
    scale = tparams["blocks"][0]["norm_mixer"]["scale"]
    got = tlayers.rmsnorm({"scale": scale}, x).float().numpy()
    want = np.asarray(jax.jit(jlayers.rmsnorm)({"scale": jnp.asarray(scale.numpy())},
                                               jnp.asarray(x.numpy())), np.float32)
    moved = np.argwhere(got != want)
    assert moved.tolist() == [[0, 7, moved[0, 2]]]
    (e,) = moved
    assert abs(got[tuple(e)] - want[tuple(e)]) == np.spacing(np.float16(abs(want[tuple(e)])))
    xf = x.float()
    t_var = torch.mean(xf * xf, dim=-1).numpy()
    j_var = np.asarray(jax.jit(lambda a: jnp.mean(a * a, axis=-1))(jnp.asarray(xf.numpy())))
    f64_var = np.mean(xf.double().numpy() ** 2, axis=-1).astype(np.float32)
    assert t_var[0, 7] == f64_var[0, 7] != j_var[0, 7]
    assert (np.abs(t_var - j_var) <= 2 * np.spacing(t_var)).all()


class _Stop(Exception):
    pass


def _cache_dtype_of(launch_mod, run, param_dtype, monkeypatch):
    """The ``cache_dtype`` a launcher hands its continuous engine for a
    reduced chatglm3-6b in ``param_dtype`` (``reduced()`` resets the dtype
    to fp32, so the stubbed ``get_config`` reduces and sets it): its
    ``ContinuousEngine`` stubbed, the run stopped at the engine."""
    seen = {}
    real = launch_mod.get_config

    def engine(**kw):
        seen["cache_dtype"] = kw["cache_dtype"]
        raise _Stop

    monkeypatch.setattr(launch_mod, "get_config", lambda arch: dataclasses.replace(
        real(arch).reduced(), param_dtype=param_dtype))
    monkeypatch.setattr(launch_mod, "ContinuousEngine", engine)
    with pytest.raises(_Stop):
        run()
    return seen["cache_dtype"]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16", "float16"])
def test_serve_launcher_keeps_kv_in_the_reference_launchers_dtype(param_dtype, monkeypatch):
    """fp32 for an fp32 model and bf16 for every other, fp16 included, as
    src/repro/launch/serve.py chooses it: both launchers driven to their
    continuous engine on one config."""
    argv = ["--arch", "chatglm3-6b", "--engine", "continuous"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    want = _cache_dtype_of(j_launch, j_launch.main, param_dtype, monkeypatch)
    got = _cache_dtype_of(t_launch, lambda: t_launch.main([*argv, "--device", "cpu"]),
                          param_dtype, monkeypatch)
    want, got = jnp.dtype(want).name, str(got).removeprefix("torch.")
    assert want == got == ("float32" if param_dtype == "float32" else "bfloat16")
    cfg = dataclasses.replace(t_get_config("chatglm3-6b"), param_dtype=param_dtype)
    assert str(t_launch.cache_dtype(cfg)).removeprefix("torch.") == got


def test_make_batch_fn_defaults_to_cuda(monkeypatch):
    """No device given: ``cuda``, which raises without a card (nothing
    quietly moves to the CPU); ``device="cpu"`` still serves the CPU."""
    ds = MarkovLMDataset(vocab=64, seq_len=8, batch=2, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch_fn(ds)
    batch = make_batch_fn(ds, device="cpu")(3)
    assert batch["tokens"].device.type == "cpu" and batch["tokens"].dtype == torch.int64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn = make_batch_fn(ds)
    assert fn.__closure__ is not None and any(
        getattr(c.cell_contents, "type", None) == "cuda" for c in fn.__closure__)


if __name__ == "__main__":
    import json

    torch.set_num_threads(4)
    first, last = (int(x) for x in sys.argv[1:3])
    for arch in ("chatglm3-6b", "deepseek-moe-16b"):
        for seed in range(first, last + 1):
            ref = _reference_run(arch, seed, 8, 8)
            row = {"arch": arch, "seed": seed}
            for variant in VARIANTS:
                gaps = _row_gaps(arch, ref, variant)
                row[variant] = {"prefill_max": float(gaps[0].max()),
                                "decode_max": float(gaps[1:].max()),
                                "clean_rows": float((gaps.max(0) <= CLEAN_GAP).mean())}
            print(json.dumps(row), flush=True)
