"""The port's chatglm3-6b model against the JAX reference, on the CPU
(and qwen2.5, the other dense ("attn", "mlp") config, for its QKV bias on
the GEMM's C preload).

Parameters come from the JAX package's ``api.init_params`` and are carried
over by ``repro_torch.convert.params_from_numpy``; both sides get the same
numpy tokens. Logits must agree within ``1e-4 * max(1, max|logits|)`` (fp32
parameters and caches: only the order of fp32 sums differs) and greedy
tokens must be identical. The JAX side runs ``backend="xla"``, and once with
``"pallas_interpret"`` (its Pallas GEMM kernel in interpret mode).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import api as tapi

MAX_LEN = 32


def _configs(n_layers=None, arch="chatglm3-6b"):
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _model(n_layers=None, arch="chatglm3-6b"):
    jcfg, tcfg = _configs(n_layers, arch)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _model()


def _jit(fn, jcfg, backend, **static):
    """A JAX entry point compiled once for the config: eager dispatch of the
    reference's layer scan costs seconds per call."""
    return jax.jit(functools.partial(fn, jcfg, backend=backend, **static))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize(
    "n_layers,arch",
    [(None, "chatglm3-6b"), (2, "chatglm3-6b"), (None, "qwen2.5-32b")],
    ids=["reduced", "2-layer", "qwen2.5-qkv-bias"],
)
def test_prefill_and_decode_match_jax_greedy_for_8_steps(n_layers, arch):
    jcfg, tcfg, jparams, tparams = _model(n_layers, arch)
    toks = _tokens((2, 11))
    prefill = _jit(japi.prefill, jcfg, "xla", max_len=MAX_LEN, cache_dtype=jnp.float32)
    jl, jc = prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, torch.float32)
    _close(tl, jl)
    jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl, -1)[:, None]
    decode = _jit(japi.decode, jcfg, "xla")
    for i in range(8):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = toks.shape[1] + i
        jl, jc = decode(jparams, jtok, jc, jnp.int32(pos))
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, pos)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl, -1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_prefill_and_decode_match_the_pallas_kernel_in_interpret_mode(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens((1, 9), seed=1)
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_LEN, jnp.float32, backend="pallas_interpret")
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                          MAX_LEN, torch.float32)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    jl, _ = japi.decode(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(9),
                        backend="pallas_interpret")
    tl, _ = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, 9)
    _close(tl, jl)


def test_bucketed_prefill_and_slot_decode_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    lengths = np.array([5, 16, 9, 1])
    toks = _tokens((4, 16), seed=2)
    prefill_bucketed = _jit(japi.prefill_bucketed, jcfg, "xla", cache_dtype=jnp.float32)
    jl, jc = prefill_bucketed(jparams, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(lengths, jnp.int32))
    tl, tc = tapi.prefill_bucketed(tcfg, tparams, torch.from_numpy(toks),
                                   torch.from_numpy(lengths), torch.float32)
    _close(tl, jl)
    # Grow the bucket-sized caches to a pool of MAX_LEN positions.
    pad = MAX_LEN - toks.shape[1]
    jc = tuple(c._replace(k=jnp.pad(c.k, ((0, 0), (0, 0), (0, pad), (0, 0))),
                          v=jnp.pad(c.v, ((0, 0), (0, 0), (0, pad), (0, 0))))
               for c in jc)
    for c in tc:
        c.k = torch.nn.functional.pad(c.k, (0, 0, 0, pad))
        c.v = torch.nn.functional.pad(c.v, (0, 0, 0, pad))
    pos = lengths.copy()
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    decode_at = _jit(japi.decode_at, jcfg, "xla")
    for _ in range(3):
        jl, jc = decode_at(jparams, jnp.asarray(tok, jnp.int32), jc,
                           jnp.asarray(pos, jnp.int32))
        tl, tc = tapi.decode_at(tcfg, tparams, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        np.testing.assert_array_equal(torch.argmax(tl, -1)[:, None].numpy(), tok)
        pos = pos + 1


def test_converter_carries_bf16_bits_and_unstacks_layers():
    jcfg, tcfg = _configs(2)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(1))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tcfg, tree, "cpu")
    assert len(params["blocks"]) == 2
    for layer in range(2):
        src = tree["blocks"][0]["mlp"]["w_gate"][layer]
        got = params["blocks"][layer]["mlp"]["w_gate"]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == src.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), src.view(np.int16))
    emb = tree["embed"]["table"]
    np.testing.assert_array_equal(
        params["embed"]["table"].view(torch.int16).numpy(), emb.view(np.int16)
    )
    # fp32 leaves (norm scales) keep their dtype and values.
    scale = params["blocks"][1]["norm_ffn"]["scale"]
    assert scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), tree["blocks"][0]["norm_ffn"]["scale"][1])
    # Round trip: the bf16 tensor's values are the numpy bf16 values.
    x = tree["lm_head"]
    np.testing.assert_array_equal(
        tensor_from_numpy(x, "cpu").float().numpy(), x.astype(np.float32)
    )


def test_port_initializer_is_a_truncated_normal_at_fan_in_scale():
    _, tcfg = _configs()
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    w = params["blocks"][0]["mlp"]["w_down"]  # fan-in d_ff
    std = tcfg.d_ff ** -0.5
    assert w.dtype == torch.float32 and tuple(w.shape) == (tcfg.d_ff, tcfg.d_model)
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert 0.7 * std < float(w.std()) < 1.0 * std  # truncation at ±2σ shrinks it
    table = params["embed"]["table"]
    assert float(table.abs().max()) <= 2 * 0.02 + 1e-6


def test_unported_patterns_raise():
    cfg = t_get_config("gemma2-9b").reduced()
    with pytest.raises(NotImplementedError):
        tapi.init_params(cfg, device="cpu")
