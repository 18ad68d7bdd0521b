"""Gradients of the port's GEMM entry points and of its training loss,
against the JAX reference's ``custom_vjp`` rules, on the CPU.

* ``ops.matmul``/``ops.linear``: every C form and every registered epilogue
  op (fused into ``matmul``; on the JAX side through both its post-hoc
  ``xla`` lane and its ``pallas_interpret`` kernel) give the same ``dA``,
  ``dB``, ``dC`` and operand cotangents as ``jax.vjp`` of
  ``repro.kernels.ops.matmul``, and the output's ``grad_fn`` is the port's
  autograd ``Function`` on both fp backends (``cuda`` runs here with its
  device type cleared, so its wrapper takes the plain version on CPU
  tensors).
* ``epilogue_vjp`` op by op against the reference's.
* ``lm_loss`` and its whole gradient tree on a 2-layer reduced chatglm3-6b
  and a 2-layer reduced deepseek-moe-16b (both dispatches, with and without
  capacity drops), remat ``"full"`` and ``"none"``, against
  ``jax.value_and_grad`` of the reference's ``loss_fn``.
* ``ops.grouped_matmul`` (:class:`repro_torch.kernels.ops._GroupedMatmul`):
  every C form and every epilogue op against ``jax.vjp`` of
  ``repro.kernels.ops.grouped_matmul`` on ``xla`` and ``pallas_interpret``,
  the backward's GEMMs on the grouped member.
* A q8-family forward (``torch_q8``) has the ``torch`` backend's gradients,
  bit for bit, dense and grouped; it is never audited under autograd; a
  pre-quantized activation under autograd raises (serving-only).

Tolerance, unless a test says otherwise: fp32 operands, ``1e-4 *
max(1, max|want|)`` (only the order of fp32 sums differs).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.tree import leaves, map_leaves

M, K, N = 6, 8, 12


def _close(got, want, scale=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    tol = scale * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _operand(rng, name):
    """An operand for op ``name`` as the user passes it (row [N], full
    [M, N], scalar), or None."""
    kind = tep.op_kind(name)
    if kind == "row":
        return _rand(rng, N)
    if kind == "full":
        return _rand(rng, M, N)
    if kind == "scalar":
        return np.float32(0.02)  # |acc| / s passes 127 for some entries: both STE regions
    return None


def _t(x):
    return torch.tensor(x, requires_grad=True)


def _find_fn(out):
    """The port's Function node of ``out``'s graph (through the reshape of
    batched inputs)."""
    node = out.grad_fn
    while node is not None and not isinstance(node, tops._Matmul._backward_cls):
        node = node.next_functions[0][0] if node.next_functions else None
    return node


@pytest.fixture(autouse=True)
def _few_threads():
    # Two torch threads for every case: keeps this file's CPU share small
    # beside the suite's wall-clock tests (the reduced models' steps are
    # mostly thread synchronisation at 8).
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["torch", "cuda"])
def backend(request, monkeypatch):
    """The two fp backends; ``cuda`` with its device type cleared, so its
    wrapper runs K1's plain version on these CPU tensors."""
    if request.param == "cuda":
        monkeypatch.setattr(tops._REGISTRY["cuda"], "device_type", None)
    return request.param


C_FORMS = ["none", "bias", "full"]


@pytest.mark.parametrize("c_form", C_FORMS)
def test_matmul_vjp_matches_jax_for_every_c_form(c_form, backend):
    rng = np.random.default_rng(C_FORMS.index(c_form))
    a, b, g = _rand(rng, 2, 3, K), _rand(rng, K, N), _rand(rng, 2, 3, N)
    c = {"none": None, "bias": _rand(rng, N), "full": _rand(rng, 2, 3, N)}[c_form]
    args = (a, b) if c is None else (a, b, c)

    want_out, pull = jax.vjp(lambda *x: jops.matmul(*x, backend="xla"), *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))
    targs = [_t(x) for x in args]
    fn = tops.linear if c_form == "bias" else tops.matmul
    out = fn(*targs, backend=backend)
    assert _find_fn(out) is not None
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        _close(x, y)


def test_two_dimensional_output_is_the_functions_own(backend):
    rng = np.random.default_rng(5)
    a, b = _t(_rand(rng, M, K)), _t(_rand(rng, K, N))
    out = tops.matmul(a, b, backend=backend, epilogue="silu")
    assert isinstance(out.grad_fn, tops._Matmul._backward_cls)
    # Without an input that requires grad the backend is called as before.
    with torch.no_grad():
        assert tops.matmul(a, b, backend=backend).grad_fn is None
    assert tops.matmul(a.detach(), b.detach(), backend=backend).grad_fn is None


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("op", tep.epilogue_ops())
def test_matmul_vjp_matches_jax_for_every_epilogue_op(op, jax_backend):
    rng = np.random.default_rng(tep.epilogue_ops().index(op))
    a, b, g = _rand(rng, M, K), _rand(rng, K, N), _rand(rng, M, N)
    o = _operand(rng, op)
    if o is None:
        fn_j = lambda a, b: jops.matmul(a, b, backend=jax_backend, epilogue=op)  # noqa: E731
        args = (a, b)
    else:
        fn_j = lambda a, b, o: jops.matmul(  # noqa: E731
            a, b, backend=jax_backend, epilogue=[(op, o)], out_dtype=jnp.float32)
        args = (a, b, o)
    want_out, pull = jax.vjp(fn_j, *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))

    targs = [_t(x) for x in args]
    step = op if o is None else [(op, targs[2])]
    out = tops.matmul(targs[0], targs[1], epilogue=step, out_dtype=torch.float32)
    assert isinstance(out.grad_fn, tops._Matmul._backward_cls)
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        assert tuple(x.shape) == tuple(np.shape(y))
        _close(x, y)


def test_matmul_vjp_of_a_chain_with_a_folded_bias_matches_jax(backend):
    """A C operand with an epilogue folds in as the chain's first step; the
    SwiGLU gate's ``silu, mul(up)`` and a ``scale`` row follow."""
    rng = np.random.default_rng(11)
    a, b, g = _rand(rng, 2, 3, K), _rand(rng, K, N), _rand(rng, 2, 3, N)
    bias, up, sc = _rand(rng, N), _rand(rng, 2, 3, N), _rand(rng, N)

    def fn_j(a, b, bias, up, sc):
        return jops.matmul(a, b, bias, backend="xla", epilogue=["silu", ("mul", up), ("scale", sc)])

    args = (a, b, bias, up, sc)
    want_out, pull = jax.vjp(fn_j, *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))
    ta = [_t(x) for x in args]
    out = tops.matmul(ta[0], ta[1], ta[2], backend=backend,
                      epilogue=["silu", ("mul", ta[3]), ("scale", ta[4])])
    got = torch.autograd.grad(out, ta, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        _close(x, y)


@pytest.mark.parametrize("op", tep.epilogue_ops())
def test_epilogue_vjp_matches_jax_op_by_op(op):
    rng = np.random.default_rng(20 + tep.epilogue_ops().index(op))
    acc, g = _rand(rng, M, N, scale=3.0), _rand(rng, M, N)
    o = _operand(rng, op)
    raw = () if o is None else (o,)
    j_ops = jep.canonicalize_operands((op,), tuple(map(jnp.asarray, raw)), n=N, m=M)
    t_ops = tep.canonicalize_operands((op,), tuple(torch.tensor(x) for x in raw), n=N, m=M)
    want_acc, want_ops = jep.epilogue_vjp((op,), j_ops, jnp.asarray(acc), jnp.asarray(g))
    got_acc, got_ops = tep.epilogue_vjp((op,), t_ops, torch.from_numpy(acc), torch.from_numpy(g))
    assert got_acc.dtype == torch.float32 and len(got_ops) == len(want_ops)
    _close(got_acc, want_acc)
    for x, y in zip(got_ops, want_ops):
        assert tuple(x.shape) == tuple(y.shape)
        _close(x, y)


def test_requant_int8_has_the_references_straight_through_vjp():
    assert tep.op_def("requant_int8").vjp is not None
    assert all(tep.op_def(n).vjp is None for n in tep.epilogue_ops() if n != "requant_int8")


# --- the training loss of a 2-layer reduced chatglm3-6b ----------------------


@functools.lru_cache(maxsize=None)
def _model(remat_policy):
    jcfg = dataclasses.replace(j_get_config("chatglm3-6b").reduced(), n_layers=2,
                               remat_policy=remat_policy)
    tcfg = dataclasses.replace(t_get_config("chatglm3-6b").reduced(), n_layers=2,
                               remat_policy=remat_policy)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(seed, b=2, s=48, vocab=256):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s))


@pytest.mark.parametrize("remat_policy", ["full", "none"])
def test_lm_loss_and_its_gradient_tree_match_jax(remat_policy):
    """S = 48 with loss_chunk 32: two 24-token CE chunks."""
    jcfg, tcfg, jparams, tparams = _model(remat_policy)
    toks, labels = _batch(1)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jbatch, backend="xla")))(jparams)

    live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss = tapi.loss_fn(tcfg, live, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(leaves(live)))
    it = iter(grads)
    got = params_to_numpy(tcfg, map_leaves(lambda _p: next(it), live))
    _close(loss, want_loss)
    want = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.shape == y.shape
        _close(x, y)


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg, tcfg, jparams, tparams = _model("full")
    back = params_to_numpy(tcfg, tparams)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)


def test_remat_full_relaunches_the_forward_gemms():
    """Under remat "full" each block's 7 GEMMs run again in the backward;
    with "none" they run once. Backward GEMMs never count into ``calls``."""
    toks, labels = _batch(2, s=16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    counts = {}
    for policy in ("full", "none"):
        _, tcfg, _, tparams = _model(policy)
        live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
        tops.reset_counts()
        torch.autograd.grad(tapi.loss_fn(tcfg, live, batch), list(leaves(live)))
        counts[policy] = tops.backend("torch").calls
    assert counts == {"full": 2 * 7 * 2, "none": 7 * 2}


def test_remat_dots_is_not_ported():
    _, tcfg, _, tparams = _model("full")
    tcfg = dataclasses.replace(tcfg, remat_policy="dots")
    toks, labels = _batch(3, s=8)
    with pytest.raises(NotImplementedError, match="dots"):
        tapi.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)})


# --- the training loss of a 2-layer reduced deepseek-moe-16b ------------------

MOE_ARCH = "deepseek-moe-16b"


@functools.lru_cache(maxsize=None)
def _moe_model(dispatch, remat_policy, dropless):
    """2 layers; with ``dropless=False`` routing groups of 16 tokens whose
    capacity (10 of 16 x 2 assignments over 4 experts) drops some."""
    def cfg(base):
        moe = dataclasses.replace(base.moe, dispatch=dispatch, dropless=dropless,
                                  group_size=16)
        return dataclasses.replace(base, n_layers=2, remat_policy=remat_policy, moe=moe)
    jcfg, tcfg = cfg(j_get_config(MOE_ARCH).reduced()), cfg(t_get_config(MOE_ARCH).reduced())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _record_routing(monkeypatch, module, sink):
    """Record each dispatch's (top_idx, capacity) by value."""
    for fname in ("_dispatch_onehot", "_dispatch_sort"):
        orig = getattr(module, fname)

        def rec(params, xg, vg, ig, n_experts, capacity, backend=None, _orig=orig):
            sink.append((np.asarray(ig), capacity))
            return _orig(params, xg, vg, ig, n_experts, capacity, backend)

        monkeypatch.setattr(module, fname, rec)


@pytest.mark.parametrize("remat_policy", ["full", "none"])
@pytest.mark.parametrize("dispatch,dropless", [("onehot", False), ("sort", False),
                                               ("sort", True)],
                         ids=["onehot-capacity", "sort-capacity", "sort-dropless"])
def test_moe_loss_and_its_gradient_tree_match_jax(monkeypatch, dispatch, dropless,
                                                  remat_policy):
    """deepseek-moe-16b's loss (the chunked CE plus 0.01 x the router's
    load-balancing loss) and every gradient leaf, router, expert stacks and
    shared MLP included, against ``jax.value_and_grad`` of the reference's
    ``loss_fn``. Every layer's routing is compared first: the JAX side's
    recorded from an eager forward (``jax.disable_jit``, without remat,
    whose trace would hide the values), the port's from its own forward,
    top_idx and capacity equal."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    jcfg, tcfg, jparams, tparams = _moe_model(dispatch, remat_policy, dropless)
    toks, labels = _batch(7, s=32)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    j_route, t_route = [], []
    with monkeypatch.context() as mp:
        _record_routing(mp, jmoe, j_route)
        _record_routing(mp, tmoe, t_route)
        with jax.disable_jit():  # the forward's values are remat's too; checkpoint traces
            japi.loss_fn(dataclasses.replace(jcfg, remat=False), jparams, jbatch, backend="xla")
        with torch.no_grad():
            tapi.loss_fn(tcfg, tparams, tbatch)
    assert len(t_route) == len(j_route) == tcfg.n_layers
    for (ti, tc), (ji, jc) in zip(t_route, j_route):
        assert tc == jc
        np.testing.assert_array_equal(ti, ji)
    if not dropless:  # the capacity cases do drop
        pos = [tmoe._positions_in_expert(torch.from_numpy(i), tcfg.moe.n_experts) for i, _ in t_route]
        assert any(bool((p >= c).any()) for p, (_, c) in zip(pos, t_route))

    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jbatch, backend="xla")))(jparams)
    live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss = tapi.loss_fn(tcfg, live, tbatch)
    grads = torch.autograd.grad(loss, list(leaves(live)))
    it = iter(grads)
    got = params_to_numpy(tcfg, map_leaves(lambda _p: next(it), live))
    _close(loss, want_loss)
    want = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert x.shape == y.shape
        _close(x, y)
    # The router's gradient reaches it through the gates (the combine
    # weights and the load-balancing loss): it is not zero.
    assert np.abs(got["blocks"][0]["moe"]["router"]).max() > 0


def test_moe_remat_full_relaunches_the_expert_gemms():
    """Under remat "full" each MoE layer's 3 expert GEMMs run again in the
    backward; with "none" they run once. Backward GEMMs never count into
    ``grouped_calls``."""
    toks, labels = _batch(8, s=16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    counts = {}
    for policy in ("full", "none"):
        _, tcfg, _, tparams = _moe_model("onehot", policy, False)
        live = map_leaves(lambda p: p.detach().clone().requires_grad_(), tparams)
        tops.reset_counts()
        torch.autograd.grad(tapi.loss_fn(tcfg, live, batch), list(leaves(live)))
        counts[policy] = (tops.backend("torch").grouped_calls, tops.backend("torch").calls)
    # 8 dense GEMMs a layer: wq, wk, wv, wo, the router, the shared MLP's 3
    assert counts == {"full": (2 * 3 * 2, 2 * 8 * 2), "none": (3 * 2, 8 * 2)}


# --- q8 forwards train on their full-precision grad backend ---------------------

Q8_FORMS = ["none", "bias", "full", "chain"]


def _q8_case(rng, form, groups=None):
    """Inputs (requiring grad), ``c`` and an epilogue for a q8-vs-fp
    gradient case; ``groups`` makes them grouped."""
    lead = () if groups is None else (groups,)
    a, b = _t(_rand(rng, *lead, M, K)), _t(_rand(rng, *lead, K, N))
    c, spec, extra = None, None, []
    if form == "bias":
        c = _t(_rand(rng, *lead, N))
    elif form == "full":
        c = _t(_rand(rng, *lead, M, N))
    elif form == "chain":
        row, full = _t(_rand(rng, *lead, N)), _t(_rand(rng, *lead, M, N))
        spec, extra = [("bias", row), "silu", ("mul", full)], [row, full]
    return a, b, c, spec, [a, b] + ([c] if c is not None else []) + extra


@pytest.mark.parametrize("form", Q8_FORMS)
def test_q8_matmul_gradients_equal_the_fp_ones_bitwise(form):
    """The port's twin of the reference's ``test_q8_gradients_run_full_precision``:
    a ``torch_q8`` forward's output is the int8 product (as under
    ``no_grad``), and its gradients are the ``torch`` backend's, bit for bit
    (the same rules on the same saved inputs, on the grad backend)."""
    rng = np.random.default_rng(30)
    a, b, c, spec, inputs = _q8_case(rng, form)
    g = torch.from_numpy(_rand(rng, M, N))
    tops.reset_counts()
    out_q = tops.matmul(a, b, c, backend="torch_q8", epilogue=spec)
    assert isinstance(_find_fn(out_q), tops._Matmul._backward_cls)
    assert tops.backend("torch_q8").calls == 1
    with torch.no_grad():
        assert torch.equal(out_q, tops.matmul(a, b, c, backend="torch_q8", epilogue=spec))
        assert not torch.equal(out_q, tops.matmul(a, b, c, backend="torch", epilogue=spec))
    got = torch.autograd.grad(out_q, inputs, g)
    want = torch.autograd.grad(tops.matmul(a, b, c, backend="torch", epilogue=spec), inputs, g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("form", Q8_FORMS)
def test_q8_grouped_matmul_gradients_equal_the_fp_ones_bitwise(form):
    rng = np.random.default_rng(31)
    a, b, c, spec, inputs = _q8_case(rng, form, groups=3)
    g = torch.from_numpy(_rand(rng, 3, M, N))
    out_q = tops.grouped_matmul(a, b, c, backend="torch_q8", epilogue=spec)
    assert isinstance(out_q.grad_fn, tops._GroupedMatmul._backward_cls)
    with torch.no_grad():
        assert torch.equal(out_q, tops.grouped_matmul(a, b, c, backend="torch_q8",
                                                      epilogue=spec))
        assert not torch.equal(out_q, tops.grouped_matmul(a, b, c, backend="torch",
                                                          epilogue=spec))
    got = torch.autograd.grad(out_q, inputs, g)
    want = torch.autograd.grad(tops.grouped_matmul(a, b, c, backend="torch", epilogue=spec),
                               inputs, g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_pre_quantized_matmul_under_grad_raises():
    """The pre-quantized lane is serving-only, as the reference's (no vjp)."""
    rng = np.random.default_rng(32)
    b = _t(_rand(rng, K, N))
    q = QuantizedTensor(torch.ones((M, K), dtype=torch.int8), torch.tensor(0.5))
    with pytest.raises(NotImplementedError, match="serving-only"):
        tops.matmul(q, b, backend="q8")
    with torch.no_grad():  # serving: unchanged
        assert tops.matmul(q, b, backend="q8").shape == (M, N)


def test_no_q8_call_under_grad_is_audited(monkeypatch):
    """``REPRO_AUDIT=1`` audits a direct q8 call, and none that runs under
    autograd (the reference's calls under ``jax.grad`` are tracers)."""
    from repro_torch import obs as tobs
    from repro_torch.obs import audit as t_audit

    monkeypatch.setenv("REPRO_AUDIT", "1")
    tobs.reset()
    t_audit.set_audit_every(None)
    try:
        rng = np.random.default_rng(33)
        a, b = _t(_rand(rng, M, K)), _t(_rand(rng, K, N))
        ga, gb = _t(_rand(rng, 2, M, K)), _t(_rand(rng, 2, K, N))
        out = tops.matmul(a, b, backend="q8", epilogue="silu")
        gout = tops.grouped_matmul(ga, gb, backend="q8")
        torch.autograd.grad((out.sum(), gout.sum()), [a, b, ga, gb])
        assert "numerics.audits" not in tobs.snapshot()["counters"]
        with torch.no_grad():
            tops.matmul(a, b, backend="q8")
            tops.grouped_matmul(ga, gb, backend="q8")
        assert tobs.snapshot()["counters"]["numerics.audits"] == {
            "backend=torch_q8,family=q8,shape=dense": 1.0,
            "backend=torch_q8,family=q8,shape=grouped": 1.0}
    finally:
        tobs.reset()
        t_audit.set_audit_every(None)


# --- the grouped GEMM's vjp ----------------------------------------------------

G = 3


def _find_grouped_fn(out):
    return out.grad_fn if isinstance(out.grad_fn, tops._GroupedMatmul._backward_cls) else None


def _grouped_operand(rng, name, row_shape=(G, N)):
    kind = tep.op_kind(name)
    if kind == "row":
        return _rand(rng, *row_shape)
    if kind == "full":
        return _rand(rng, G, M, N)
    if kind == "scalar":
        return np.float32(0.02)
    return None


GROUPED_C_FORMS = ["none", "bias", "full"]


@pytest.mark.parametrize("c_form", GROUPED_C_FORMS)
def test_grouped_vjp_matches_jax_for_every_c_form(c_form, backend):
    """dA[g] = dO[g] B[g]^T, dB[g] = A[g]^T dO[g]; a [G, N] bias gets the
    sum over rows, a full C the cotangent itself."""
    rng = np.random.default_rng(40 + GROUPED_C_FORMS.index(c_form))
    a, b, g = _rand(rng, G, M, K), _rand(rng, G, K, N), _rand(rng, G, M, N)
    c = {"none": None, "bias": _rand(rng, G, N), "full": _rand(rng, G, M, N)}[c_form]
    args = (a, b) if c is None else (a, b, c)
    want_out, pull = jax.vjp(lambda *x: jops.grouped_matmul(*x, backend="xla"),
                             *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))
    targs = [_t(x) for x in args]
    out = tops.grouped_matmul(*targs, backend=backend)
    assert _find_grouped_fn(out) is not None
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        assert tuple(x.shape) == tuple(np.shape(y))
        _close(x, y)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("op", tep.epilogue_ops())
def test_grouped_vjp_matches_jax_for_every_epilogue_op(op, jax_backend):
    rng = np.random.default_rng(50 + tep.epilogue_ops().index(op))
    a, b, g = _rand(rng, G, M, K), _rand(rng, G, K, N), _rand(rng, G, M, N)
    o = _grouped_operand(rng, op)
    if o is None:
        fn_j = lambda a, b: jops.grouped_matmul(a, b, backend=jax_backend, epilogue=op)  # noqa: E731
        args = (a, b)
    else:
        fn_j = lambda a, b, o: jops.grouped_matmul(  # noqa: E731
            a, b, backend=jax_backend, epilogue=[(op, o)], out_dtype=jnp.float32)
        args = (a, b, o)
    want_out, pull = jax.vjp(fn_j, *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))

    targs = [_t(x) for x in args]
    step = op if o is None else [(op, targs[2])]
    out = tops.grouped_matmul(targs[0], targs[1], epilogue=step, out_dtype=torch.float32)
    assert _find_grouped_fn(out) is not None
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        assert tuple(x.shape) == tuple(np.shape(y))
        _close(x, y)


@pytest.mark.parametrize("row", ["[N]", "[G, N]"])
def test_grouped_vjp_of_the_expert_chain_matches_jax(row, backend):
    """The experts' gate chain (``silu, mul(up)``) behind a folded ``[G, N]``
    bias and a ``scale`` row given as ``[N]`` (broadcast over groups) or
    ``[G, N]``: each operand's gradient in its own shape."""
    rng = np.random.default_rng(60)
    a, b, g = _rand(rng, G, M, K), _rand(rng, G, K, N), _rand(rng, G, M, N)
    bias, up = _rand(rng, G, N), _rand(rng, G, M, N)
    sc = _rand(rng, N) if row == "[N]" else _rand(rng, G, N)

    def fn_j(a, b, bias, up, sc):
        return jops.grouped_matmul(a, b, bias, backend="xla",
                                   epilogue=["silu", ("mul", up), ("scale", sc)])

    args = (a, b, bias, up, sc)
    want_out, pull = jax.vjp(fn_j, *map(jnp.asarray, args))
    want = pull(jnp.asarray(g))
    ta = [_t(x) for x in args]
    out = tops.grouped_matmul(ta[0], ta[1], ta[2], backend=backend,
                              epilogue=["silu", ("mul", ta[3]), ("scale", ta[4])])
    got = torch.autograd.grad(out, ta, torch.from_numpy(g))
    _close(out, want_out)
    for x, y in zip(got, want):
        assert tuple(x.shape) == tuple(np.shape(y))
        _close(x, y)


def test_grouped_backward_runs_on_the_grouped_member(backend):
    """Backward GEMMs go to the grad backend's ``grouped_fn`` (K4 on the
    card) and count neither into ``grouped_calls`` nor into ``calls``; an
    epilogue'd product recomputes its fp32 accumulator first."""
    rng = np.random.default_rng(61)
    a, b = _t(_rand(rng, G, M, K)), _t(_rand(rng, G, K, N))
    up = _t(_rand(rng, G, M, N))
    seen = []
    be = tops.backend(backend)
    real = be.grouped_fn

    def spy(x, y, c=None, **kw):
        seen.append((tuple(x.shape), tuple(y.shape), kw.get("out_dtype"), bool(kw.get("epilogue"))))
        return real(x, y, c, **kw)

    tops.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(be, "grouped_fn", spy)
        out = tops.grouped_matmul(a, b, backend=backend, epilogue=["silu", ("mul", up)])
        torch.autograd.grad(out.sum(), (a, b, up))
    assert seen == [((G, M, K), (G, K, N), torch.float32, True),
                    ((G, M, K), (G, K, N), torch.float32, False),
                    ((G, M, N), (G, N, K), torch.float32, False),
                    ((G, K, M), (G, M, N), torch.float32, False)]
    assert (be.grouped_calls, be.calls) == (1, 0)
