"""The port's llava-next-mistral-7b (the vlm family) against the JAX
reference, on the CPU.

Reduced config (8 image rows, fp32 parameters carried over by
``repro_torch.convert.params_from_numpy``); both sides get the same numpy
tokens and patch embeddings. Logits must agree within ``1e-4 * max(1,
max|logits|)`` and greedy tokens must be identical. The reference's static
engine decodes at ``prompt_len`` where the cache holds ``n_img_tokens +
prompt_len`` positions, so the port's engine is held against the
reference's ``api.prefill`` and ``api.decode`` at the true position, which
the tests drive themselves, and against a teacher-forced full forward.
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
from repro.models import transformer as jtf
from repro.models import vlm as jvlm
from repro.tune import capture as j_capture
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as tapi
from repro_torch.models import vlm as tvlm
from repro_torch.tree import leaves, map_leaves
from repro_torch.tune import capture as t_capture

ARCH = "llava-next-mistral-7b"
PROMPT, GEN = 11, 8


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
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
    img = rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
    return toks, img


def _jbatch(toks, img):
    return {"tokens": jnp.asarray(toks, jnp.int32), "patch_embeds": jnp.asarray(img)}


def _tbatch(toks, img):
    return {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(img)}


def _max_len(cfg):
    return cfg.n_img_tokens + PROMPT + GEN


def _jax_true_position(jcfg, jparams, toks, img, backend="xla", steps=GEN):
    """The reference's prefill, then its decode at the true position
    ``n_img + prompt + i``: the logits of each step and the greedy tokens."""
    prefill = jax.jit(functools.partial(japi.prefill, jcfg, max_len=_max_len(jcfg),
                                        cache_dtype=jnp.float32, backend=backend))
    decode = jax.jit(functools.partial(japi.decode, jcfg, backend=backend))
    logits, caches = prefill(jparams, _jbatch(toks, img))
    rows, out = [np.asarray(logits)], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(steps - 1):
        out.append(np.asarray(tok))
        logits, caches = decode(jparams, tok, caches, jnp.int32(jcfg.n_img_tokens + toks.shape[1] + i))
        rows.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out.append(np.asarray(tok))
    return rows, np.concatenate(out, axis=1)


def test_project_image_matches_jax():
    jcfg, tcfg, jparams, tparams = _model()
    _, img = _inputs(tcfg, seed=3)
    want = jvlm.project_image(jparams, jnp.asarray(img), backend="xla")
    _close(tvlm.project_image(tparams, torch.from_numpy(img)), want)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_prefill_and_decode_match_jax_at_the_true_position(backend):
    jcfg, tcfg, jparams, tparams = _model()
    toks, img = _inputs(tcfg)
    steps = GEN if backend == "xla" else 2
    want, _ = _jax_true_position(jcfg, jparams, toks, img, backend, steps)
    logits, caches = tapi.prefill(tcfg, tparams, _tbatch(toks, img), _max_len(tcfg),
                                  torch.float32)
    assert caches[0].length == tcfg.n_img_tokens + PROMPT
    _close(logits, want[0])
    for i in range(steps - 1):
        tok = torch.argmax(logits, -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.argmax(want[i], -1)[:, None])
        logits, caches = tapi.decode(tcfg, tparams, tok, caches, tcfg.n_img_tokens + PROMPT + i)
        _close(logits, want[i + 1])


def test_engine_greedy_stream_equals_the_true_position_decode():
    from repro_torch.serve import ServeEngine

    jcfg, tcfg, jparams, tparams = _model()
    toks, img = _inputs(tcfg, seed=1)
    _, want = _jax_true_position(jcfg, jparams, toks, img)
    eng = ServeEngine(cfg=tcfg, params=tparams, max_len=_max_len(tcfg),
                      cache_dtype=torch.float32)
    got = eng.generate(_tbatch(toks, img), GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decoded_logits_equal_a_full_forward_teacher_forced():
    """Each decode step's logits equal those of one full forward of the
    reference over the image rows, the prompt and the tokens so far."""
    jcfg, tcfg, jparams, tparams = _model()
    toks, img = _inputs(tcfg, seed=2)
    logits, caches = tapi.prefill(tcfg, tparams, _tbatch(toks, img), _max_len(tcfg),
                                  torch.float32)
    seq = toks
    for i in range(GEN):
        hidden, _, _ = jvlm.vlm_forward(jparams, jnp.asarray(seq, jnp.int32), jnp.asarray(img),
                                        jcfg, mode="prefill", backend="xla")
        _close(logits, jtf.lm_logits(jparams, hidden[:, -1:], jcfg)[:, 0])
        tok = torch.argmax(logits, -1)[:, None]
        seq = np.concatenate([seq, tok.numpy()], axis=1)
        if i < GEN - 1:
            logits, caches = tapi.decode(tcfg, tparams, tok, caches,
                                         tcfg.n_img_tokens + PROMPT + i)


def test_loss_and_every_gradient_match_jax():
    """The test_models_smoke layout: 2 rows of 32 positions, 8 of them the
    image's; the loss over the 24 text positions."""
    jcfg, tcfg, jparams, tparams = _model()
    rng = np.random.default_rng(5)
    s_text = 32 - tcfg.n_img_tokens
    toks, labels = (rng.integers(0, tcfg.vocab, (2, s_text)) for _ in range(2))
    img = rng.standard_normal((2, tcfg.n_img_tokens, tcfg.d_model), dtype=np.float32)
    jbatch = {**_jbatch(toks, img), "labels": jnp.asarray(labels, jnp.int32)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jbatch, backend="xla")))(jparams)
    live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss = tapi.loss_fn(tcfg, live, {**_tbatch(toks, img), "labels": torch.from_numpy(labels)})
    grads = iter(torch.autograd.grad(loss, list(leaves(live))))
    got = params_to_numpy(tcfg, map_leaves(lambda _p: next(grads), live))
    _close(loss, want_loss)
    want = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.shape == y.shape
        _close(x, y)


def test_lm_loss_drops_the_image_positions_as_the_reference_does():
    """``lm_loss`` on a config with image rows and no image input: the
    first ``n_img_tokens`` positions of the tokens' own forward are not
    scored, as in the reference."""
    from repro_torch.models import transformer as ttf

    jcfg, tcfg, jparams, tparams = _model()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab, (2, 24))
    labels = rng.integers(0, tcfg.vocab, (2, 24 - tcfg.n_img_tokens))
    want = jtf.lm_loss(jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32),
                       jcfg, backend="xla")
    _close(ttf.lm_loss(tparams, torch.from_numpy(toks), torch.from_numpy(labels), tcfg), want)


def test_params_to_numpy_inverts_params_from_numpy():
    _, tcfg, jparams, tparams = _model()
    back = params_to_numpy(tcfg, tparams)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)


def test_parameter_count_matches_jax_at_published_width():
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    assert tapi.param_count(tcfg) == japi.param_count(jcfg) == 7_275_286_528


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(kind):
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    seq = jcfg.n_img_tokens + 64
    want = japi.input_specs(jcfg, batch=3, seq=seq, kind=kind)
    got = tapi.input_specs(tcfg, batch=3, seq=seq, kind=kind)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape)
        assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)
        assert got[k].device.type == "meta"


def test_harvest_equals_the_reference_at_published_widths():
    seq = j_get_config(ARCH).n_img_tokens + 64
    got = t_capture.harvest_model_shapes(ARCH, batch=2, seq=seq)
    want = j_capture.harvest_model_shapes(ARCH, batch=2, seq=seq)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    d = t_get_config(ARCH).d_model
    assert ("dense", 2 * 2880, d, d, 0, "bfloat16") in [tuple(s) for s in got]  # the projector


def test_continuous_and_token_prompt_entry_points_refuse_the_family():
    from repro_torch.serve import ContinuousEngine

    _, tcfg, _, tparams = _model()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="use ServeEngine for vlm"):
        ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32)
    with pytest.raises(NotImplementedError):
        tapi.prefill_bucketed(tcfg, tparams, toks, torch.tensor([4]))
    caches = tapi.init_state(tcfg, 1, 32, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        tapi.prefill_chunk(tcfg, tparams, toks, caches, torch.tensor([0]), torch.tensor([3]))


def test_a_cache_too_short_for_the_image_rows_raises():
    _, tcfg, _, tparams = _model()
    toks, img = _inputs(tcfg, b=1)
    with pytest.raises(ValueError, match="cache"):
        tapi.prefill(tcfg, tparams, _tbatch(toks, img), tcfg.n_img_tokens + PROMPT - 1,
                     torch.float32)
    need = tcfg.n_img_tokens + PROMPT
    logits, caches = tapi.prefill(tcfg, tparams, _tbatch(toks, img), need, torch.float32)
    with pytest.raises(ValueError, match="cache"):
        tapi.decode(tcfg, tparams, logits.argmax(-1)[:, None], caches, need)
