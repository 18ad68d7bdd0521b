"""The port's whisper-base (the audio family, an encoder-decoder) against
the JAX reference, on the CPU.

Reduced config (24 frames, one encoder and one decoder layer, fp32
parameters carried over by ``repro_torch.convert.params_from_numpy``); both
sides get the same numpy tokens and frames. Logits must agree within
``1e-4 * max(1, max|logits|)`` and greedy tokens must be identical.
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
from repro.models import encdec as jencdec
from repro.serve import ServeEngine as JServe
from repro.tune import capture as j_capture
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from repro_torch.tree import leaves, map_leaves
from repro_torch.tune import capture as t_capture

ARCH = "whisper-base"
PROMPT, GEN = 9, 8
MAX_LEN = PROMPT + GEN


@functools.lru_cache(maxsize=None)
def _model(n_layers=None):
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers, n_enc_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers, n_enc_layers=n_layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, scale=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(1.0, float(np.abs(want).max())))


def _inputs(cfg, b=2, s=PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s))
    frames = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return toks, frames


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks, jnp.int32), "frames": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}


def test_encoder_and_cross_kv_match_jax():
    jcfg, tcfg, jparams, tparams = _model(2)
    _, frames = _inputs(tcfg, seed=3)
    want = jencdec.encode(jparams, jnp.asarray(frames), jcfg, backend="xla")
    got = tencdec.encode(tparams, torch.from_numpy(frames), tcfg)
    _close(got, want)
    want_k, want_v = jencdec._cross_kv(jparams["dec_blocks"], want, jcfg, "xla")
    got_k, got_v = tencdec._cross_kv(tparams["dec_blocks"], got, tcfg, None)
    assert len(got_k) == len(got_v) == 2
    for layer in range(2):
        _close(got_k[layer], want_k[layer])
        _close(got_v[layer], want_v[layer])


@pytest.mark.parametrize("n_layers,backend", [(None, "xla"), (2, "xla"),
                                              (None, "pallas_interpret")])
def test_prefill_and_decode_match_jax(n_layers, backend):
    jcfg, tcfg, jparams, tparams = _model(n_layers)
    toks, frames = _inputs(tcfg)
    steps = GEN if backend == "xla" else 2
    jl, jc = jax.jit(functools.partial(japi.prefill, jcfg, max_len=MAX_LEN,
                                       cache_dtype=jnp.float32, backend=backend))(
        jparams, _jbatch(toks, frames))
    tl, tc = tapi.prefill(tcfg, tparams, _tbatch(toks, frames), MAX_LEN, torch.float32)
    assert isinstance(tc, tencdec.EncDecCaches) and tc.self_kv[0].length == PROMPT
    _close(tl, jl)
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend=backend))
    for i in range(steps - 1):
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = decode(jparams, jtok, jc, jnp.int32(PROMPT + i))
        tl, tc = tapi.decode(tcfg, tparams, ttok, tc, PROMPT + i)
        _close(tl, jl)


def test_engine_greedy_stream_equals_the_references_engine():
    from repro_torch.serve import ServeEngine

    jcfg, tcfg, jparams, tparams = _model()
    toks, frames = _inputs(tcfg, seed=1)
    want = JServe(cfg=jcfg, params=jparams, max_len=MAX_LEN, cache_dtype=jnp.float32).generate(
        _jbatch(toks, frames), GEN)
    got = ServeEngine(cfg=tcfg, params=tparams, max_len=MAX_LEN,
                      cache_dtype=torch.float32).generate(_tbatch(toks, frames), GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decoded_logits_equal_a_full_decoder_forward_teacher_forced():
    """Each decode step's logits equal those of the reference's decoder run
    once over the prompt and the tokens so far, against the same frames."""
    jcfg, tcfg, jparams, tparams = _model()
    toks, frames = _inputs(tcfg, seed=2)
    enc = jencdec.encode(jparams, jnp.asarray(frames), jcfg, backend="xla")
    logits, caches = tapi.prefill(tcfg, tparams, _tbatch(toks, frames), MAX_LEN, torch.float32)
    seq = toks
    for i in range(GEN):
        hidden, _ = jencdec.decoder_forward(jparams, jnp.asarray(seq, jnp.int32), jcfg,
                                            enc_out=enc, mode="prefill", backend="xla")
        _close(logits, hidden[:, -1] @ jparams["embed"]["table"].T)
        tok = torch.argmax(logits, -1)[:, None]
        seq = np.concatenate([seq, tok.numpy()], axis=1)
        if i < GEN - 1:
            logits, caches = tapi.decode(tcfg, tparams, tok, caches, PROMPT + i)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_jax(remat):
    """The test_models_smoke layout: 2 rows of 32 tokens and all frames."""
    jcfg, tcfg, jparams, tparams = _model()
    tcfg = dataclasses.replace(tcfg, remat=remat)
    rng = np.random.default_rng(5)
    toks, labels = (rng.integers(0, tcfg.vocab, (2, 32)) for _ in range(2))
    frames = rng.standard_normal((2, tcfg.enc_seq, tcfg.d_model), dtype=np.float32)
    jbatch = {**_jbatch(toks, frames), "labels": jnp.asarray(labels, jnp.int32)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jbatch, backend="xla")))(jparams)
    live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss = tapi.loss_fn(tcfg, live, {**_tbatch(toks, frames), "labels": torch.from_numpy(labels)})
    grads = iter(torch.autograd.grad(loss, list(leaves(live))))
    got = params_to_numpy(tcfg, map_leaves(lambda _p: next(grads), live))
    _close(loss, want_loss)
    want = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.shape == y.shape
        _close(x, y)


def test_params_to_numpy_inverts_params_from_numpy():
    _, tcfg, jparams, tparams = _model(2)
    assert len(tparams["enc_blocks"]) == len(tparams["dec_blocks"]) == 2
    back = params_to_numpy(tcfg, tparams)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)


def test_parameter_count_matches_jax_at_published_width():
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    assert tapi.param_count(tcfg) == japi.param_count(jcfg) == 71_395_840


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(kind):
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    want = japi.input_specs(jcfg, batch=3, seq=64, kind=kind)
    got = tapi.input_specs(tcfg, batch=3, seq=64, kind=kind)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape)
        assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)


def test_harvest_equals_the_reference_at_published_widths():
    got = t_capture.harvest_model_shapes(ARCH, batch=2, seq=64)
    want = j_capture.harvest_model_shapes(ARCH, batch=2, seq=64)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert ("dense", 2 * 1500, 512, 2048, 0, "bfloat16") in [tuple(s) for s in got]  # encoder


def test_slot_and_token_prompt_entry_points_refuse_the_family():
    from repro_torch.serve import ContinuousEngine

    _, tcfg, _, tparams = _model()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="use ServeEngine for audio"):
        ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError):
        tapi.prefill_bucketed(tcfg, tparams, toks, torch.tensor([4]))
    caches = tapi.init_state(tcfg, 1, 32, torch.float32, device="cpu")
    assert isinstance(caches, tencdec.EncDecCaches)
    with pytest.raises(NotImplementedError):
        tapi.prefill_chunk(tcfg, tparams, toks, caches, torch.tensor([0]), torch.tensor([3]))
    with pytest.raises(NotImplementedError):
        tapi.decode_at(tcfg, tparams, toks[:, :1], caches, torch.tensor([0]))


def test_a_cache_too_short_raises():
    _, tcfg, _, tparams = _model()
    toks, frames = _inputs(tcfg, b=1)
    with pytest.raises(ValueError, match="cache"):
        tapi.prefill(tcfg, tparams, _tbatch(toks, frames), PROMPT - 1, torch.float32)
    logits, caches = tapi.prefill(tcfg, tparams, _tbatch(toks, frames), PROMPT, torch.float32)
    with pytest.raises(ValueError, match="cache"):
        tapi.decode(tcfg, tparams, logits.argmax(-1)[:, None], caches, PROMPT)
