"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the JAX
reference's (``repro.models.xlstm``), on the CPU.

Parameters come from the reference's ``mlstm_init`` / ``slstm_init`` at the
reduced xlstm-125m's width (d_model 64, 4 heads of 16) in fp32, inputs from
a numpy seed. The mLSTM's chunkwise-parallel prefill (chunks of 8: a
multiple of the chunk, a prime length where the chunk shrinks to 1, and
one token), its returned state and decode steps from it, and the sLSTM's
token loop, state and decode steps must agree within ``FP32_TOL``
(relative and absolute). The chunkwise form against the token-by-token
recurrence shows the state carried across chunks is the recurrence's.
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
from repro.models import xlstm as jx
from repro.models.layers import Initializer as JInit
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import Initializer
from repro_torch.tree import map_leaves

FP32_TOL = 2e-4
ARCH = "xlstm-125m"
CHUNK = 8
D, H = 64, 4


@functools.lru_cache(maxsize=None)
def _params(kind):
    init = {"mlstm": jx.mlstm_init, "slstm": jx.slstm_init}[kind]
    jp = init(jax.random.key(4), D, H, init=JInit(dtype=jnp.float32))
    return jp, map_leaves(lambda x: tensor_from_numpy(np.asarray(x), "cpu"), dict(jp))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_TOL, atol=FP32_TOL)


def _state_close(got, want):
    for f in dataclasses.fields(got):
        _close(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_and_zero_state_match_the_reference(kind):
    jp, _ = _params(kind)
    make = {"mlstm": tx.mlstm_init, "slstm": tx.slstm_init}[kind]
    tp = make(D, H, Initializer(dtype=torch.float32))
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and str(tp[k].dtype)[6:] == str(jp[k].dtype), k
    bias = "b_if" if kind == "mlstm" else "b"
    np.testing.assert_array_equal(_np(tp[bias]), np.asarray(jp[bias]))
    jstate = (jx.MLSTMState if kind == "mlstm" else jx.SLSTMState).zeros(2, H, D // H)
    tstate = (tx.MLSTMState if kind == "mlstm" else tx.SLSTMState).zeros(2, H, D // H, "cpu")
    for f in dataclasses.fields(tstate):
        np.testing.assert_array_equal(_np(getattr(tstate, f.name)), np.asarray(getattr(jstate, f.name)))


@pytest.mark.parametrize("s", [16, 13, 1], ids=["chunk-multiple", "prime", "one-token"])
def test_mlstm_apply_and_its_state_match_jax(s):
    jp, tp = _params("mlstm")
    x = _x((2, s, D), seed=s)
    want, wstate = jx.mlstm_apply(jp, jnp.asarray(x), n_heads=H, chunk=CHUNK, backend="xla",
                                  return_state=True)
    got, gstate = tx.mlstm_apply(tp, torch.from_numpy(x), n_heads=H, chunk=CHUNK,
                                 return_state=True)
    _close(got, want)
    _state_close(gstate, wstate)


def test_mlstm_decode_steps_from_the_prefill_state_match_jax():
    jp, tp = _params("mlstm")
    x = _x((2, 12, D), seed=7)
    _, wstate = jx.mlstm_apply(jp, jnp.asarray(x), n_heads=H, chunk=CHUNK, backend="xla",
                               return_state=True)
    _, gstate = tx.mlstm_apply(tp, torch.from_numpy(x), n_heads=H, chunk=CHUNK,
                               return_state=True)
    for i in range(4):
        xt = _x((2, 1, D), seed=30 + i)
        want, wstate = jx.mlstm_decode_step(jp, jnp.asarray(xt), wstate, n_heads=H, backend="xla")
        got, gstate = tx.mlstm_decode_step(tp, torch.from_numpy(xt), gstate, n_heads=H)
        _close(got, want)
        _state_close(gstate, wstate)


def test_mlstm_chunkwise_form_equals_the_recurrence():
    """The chunkwise-parallel prefill over 16 tokens (two chunks of 8)
    gives the outputs and the final state of 16 one-token recurrence steps
    from the zero state."""
    _, tp = _params("mlstm")
    x = torch.from_numpy(_x((2, 16, D), seed=8))
    full, fstate = tx.mlstm_apply(tp, x, n_heads=H, chunk=CHUNK, return_state=True)
    state = tx.MLSTMState.zeros(2, H, D // H, "cpu")
    for t in range(16):
        y, state = tx.mlstm_decode_step(tp, x[:, t:t + 1], state, n_heads=H)
        _close(y[:, 0], full[:, t])
    _close(state.c, fstate.c)
    _close(state.n, fstate.n)


@pytest.mark.parametrize("s", [9, 1])
def test_slstm_apply_and_its_state_match_jax(s):
    jp, tp = _params("slstm")
    x = _x((2, s, D), seed=40 + s)
    want, wstate = jx.slstm_apply(jp, jnp.asarray(x), n_heads=H, backend="xla", return_state=True)
    got, gstate = tx.slstm_apply(tp, torch.from_numpy(x), n_heads=H, return_state=True)
    _close(got, want)
    _state_close(gstate, wstate)


def test_slstm_decode_steps_from_the_prefill_state_match_jax():
    jp, tp = _params("slstm")
    x = _x((2, 6, D), seed=50)
    _, wstate = jx.slstm_apply(jp, jnp.asarray(x), n_heads=H, backend="xla", return_state=True)
    _, gstate = tx.slstm_apply(tp, torch.from_numpy(x), n_heads=H, return_state=True)
    for i in range(4):
        xt = _x((2, 1, D), seed=60 + i)
        want, wstate = jx.slstm_decode_step(jp, jnp.asarray(xt), wstate, n_heads=H, backend="xla")
        got, gstate = tx.slstm_decode_step(tp, torch.from_numpy(xt), gstate, n_heads=H)
        _close(got, want)
        _state_close(gstate, wstate)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("s", [1, 11], ids=["one-token-prefill", "prefill"])
def test_model_prefill_states_and_a_decode_step_match_jax(s):
    """Through the whole model (one sLSTM and one mLSTM block, no FFN): the
    logits, every layer's state (a 1-token prompt takes the decode step
    from the zero state, as in the reference) and one decode step."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = np.random.default_rng(s).integers(0, 256, (2, s))
    jl, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, 16,
                          jnp.float32, backend="xla")
    tl, tc = tapi.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, 16, torch.float32)
    tol = 1e-4 * max(1.0, float(np.abs(np.asarray(jl)).max()))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=tol)
    assert [type(c).__name__ for c in tc] == ["SLSTMState", "MLSTMState"]
    assert list(tparams["blocks"][0]) == ["norm_mixer", "slstm"]
    for layer, c in enumerate(tc):
        _state_close(c, jax.tree.map(lambda a: a[0], jc[layer]))
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    jl, _ = japi.decode(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc, jnp.int32(s),
                        backend="xla")
    tl, _ = tapi.decode(tcfg, tparams, torch.from_numpy(tok), tc, s)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=tol)
