"""Registry-wide conformance suite of the port's GEMM backends, on the CPU.

The port of ``tests/test_backend_conformance.py``: one parametrized
contract over every member of ``repro_torch.kernels.ops.registered_backends()``
(``cuda``, ``cuda_q8``, ``torch``, ``torch_q8``), each case held against the
JAX registry's member of the same numerics family (``xla`` for ``fp``,
``xla_q8`` for ``q8``) on the same numpy inputs:

* the reference contract, the single final cast and the bias in the backend;
* the vjp of every member (through ``ops._Matmul``): the q8 members
  backpropagate on their full-precision ``grad_backend``, bit for bit its
  gradients, as the reference's; a pre-quantized activation under grad
  raises (serving-only);
* grouped equals stacked, with a bias and with every epilogue op, and the
  grouped gradients (through ``ops._GroupedMatmul``);
* every epilogue op on both lanes, fused (the chain at the backend's
  writeback) and post-hoc (an fp32 product, the chain, one cast), with its
  single final cast; the epilogue's vjp against the unfused composition;
* resolution never crossing numerics families, 2-D and grouped;
* an op registered at run time, under a new name or replacing ``silu``,
  runs post-hoc on every backend and gives the reference's result; no op
  without a kernel code reaches a kernel's epilogue struct.

The ``cuda*`` members run here with their device type cleared: their
wrappers take the plain versions on CPU tensors, so these cases hold the
registry's plumbing, not the kernels (``tests/test_torch_gpu.py`` runs them
on the card). The reference's fallback and degradation cases
(``test_fallback_chain_declared_and_family_preserving``,
``test_degradation_warns_and_preserves_family``,
``test_degradation_preserves_epilogue``,
``test_grouped_resolution_degrades_with_warning``,
``test_grouped_only_failure_keeps_the_2d_member``) are not ported: the port
has no fallback chains and no availability probes, so they hold nothing.

Tolerances are the reference's (``_tolerance``): ``1e-4 * max|want| +
1e-5`` for fp members (the order of fp32 sums), ``0.03 * max|want|`` for q8
members (the per-row and per-column scale bound); the port's own lanes
against each other to ``1e-5``, and casts bitwise. ``requant_int8`` against
JAX allows one int8 step more: a last-bit difference in the accumulator
may round to the neighbouring step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro.kernels.ref import reference_grouped_matmul, reference_matmul
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import ops
from repro_torch.kernels.opope_gemm import _epilogue_struct
from repro_torch.kernels.opope_grouped import opope_gemm_grouped_plain
from repro_torch.quant import backends as q8b
from repro_torch.quant.quantize import QuantizedTensor

jops._load_plugin_backends()
ALL_BACKENDS = sorted(ops.registered_backends())
J_MEMBER = {"fp": "xla", "q8": "xla_q8"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def name(request, monkeypatch):
    """A registered backend; a ``cuda*`` one with its device type cleared."""
    be = ops.backend(request.param)
    if be.device_type == "cuda":
        monkeypatch.setattr(be, "device_type", None)
    return request.param


def _over_backends(fn):
    return pytest.mark.parametrize("name", ALL_BACKENDS, indirect=True)(fn)


def _tolerance(name, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    if ops.family_of(name) == "q8":
        return 0.03 * float(np.abs(want).max())
    return 1e-4 * float(np.abs(want).max()) + 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, dtype=np.float32)


def _jax_close(name, got, want, extra=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tolerance(name, want) + extra)


def _operands(m=48, k=96, n=72, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _grouped_operands(g=3, m=24, k=64, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, m, k)).astype(np.float32),
            rng.standard_normal((g, k, n)).astype(np.float32))


def _t(*xs, grad=False):
    out = [torch.tensor(x, requires_grad=grad) for x in xs]
    return out if len(out) > 1 else out[0]


def _jmember(name):
    return J_MEMBER[ops.family_of(name)]


# --- the shared numerics contract -------------------------------------------


@_over_backends
def test_matches_reference_contract(name):
    a, b = _operands()
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), backend=_jmember(name))
    got = ops.matmul(*_t(a, b), backend=name)
    assert got.dtype == torch.float32
    _jax_close(name, got, want)
    # and the family's contract against the oracle, as the reference's case
    _jax_close(name, got, reference_matmul(jnp.asarray(a), jnp.asarray(b)))


@_over_backends
def test_single_final_cast(name):
    a, b = _operands(seed=1)
    wide = ops.matmul(*_t(a, b), backend=name, out_dtype=torch.float32)
    narrow = ops.matmul(*_t(a, b), backend=name, out_dtype=torch.bfloat16)
    assert narrow.dtype == torch.bfloat16
    assert torch.equal(narrow, wide.to(torch.bfloat16))
    _jax_close(name, wide, jops.matmul(jnp.asarray(a), jnp.asarray(b), backend=_jmember(name),
                                       out_dtype=jnp.float32))


@_over_backends
def test_single_final_cast_to_every_narrow_dtype(name):
    """Each narrow out dtype a family writes (bf16 and fp16; the fp family
    also e4m3 and e5m2, which the int8 kernels do not write) is one cast of
    the fp32 product by the kernels' rule (``epilogue.cast_out``: round to
    nearest even, e4m3 past 448 NaN), bit for bit. The product is scaled
    so that some sums pass 448."""
    a, b = _operands(seed=1)
    a = a * 40.0
    wide = ops.matmul(*_t(a, b), backend=name, out_dtype=torch.float32)
    narrow = [torch.bfloat16, torch.float16]
    if ops.family_of(name) == "fp":
        narrow += [torch.float8_e4m3fn, torch.float8_e5m2]
    for dt in narrow:
        got = ops.matmul(*_t(a, b), backend=name, out_dtype=dt)
        assert got.dtype == dt
        assert torch.equal(got.view(torch.uint8), tep.cast_out(wide, dt).view(torch.uint8))
    assert tep.cast_out(wide, torch.float8_e4m3fn).float().isnan().any()


@_over_backends
def test_bias_rides_the_backend(name):
    a, b = _operands(seed=2)
    bias = np.random.default_rng(3).standard_normal(b.shape[1]).astype(np.float32)
    no_bias = ops.matmul(*_t(a, b), backend=name)
    with_bias = ops.matmul(*_t(a, b, bias), backend=name)
    np.testing.assert_allclose(_np(with_bias), _np(no_bias) + bias[None, :], rtol=1e-6, atol=1e-6)
    _jax_close(name, with_bias, jops.matmul(*map(jnp.asarray, (a, b, bias)),
                                            backend=_jmember(name)))


@_over_backends
def test_vjp_of_every_fp_member(name):
    """sum() makes the cotangent all-ones, so every member's backward sees
    the same cotangent; fp32 sums on both sides, reassociation noise only.
    A q8 member's backward is its fp grad backend's, so it holds too."""
    a, b = _operands(m=24, k=48, n=32, seed=4)
    ta, tb = _t(a, b, grad=True)
    out = ops.matmul(ta, tb, backend=name)
    assert isinstance(out.grad_fn, ops._Matmul._backward_cls)
    da, db = torch.autograd.grad(out.sum(), (ta, tb))
    want = jax.grad(lambda a, b: jops.matmul(a, b, backend="xla").sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    for x, y in zip((da, db), want):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-4, atol=1e-4)


@_over_backends
def test_q8_members_have_a_full_precision_grad_backend_and_refuse_grad(name, monkeypatch):
    """A q8 member's gradients are its fp grad backend's, bit for bit,
    dense and grouped (the reference's grad-backend indirection); what
    refuses grad is the serving-only pre-quantized lane."""
    if ops.family_of(name) != "q8":
        assert ops.grad_backend_of(name) == name  # fp: backward on itself
        return
    gb = ops.grad_backend_of(name)
    assert ops.family_of(gb) == "fp", f"{name} backpropagates through {gb}"
    assert ops.backend(gb).grouped_fn is not None  # a grouped backward has its member
    monkeypatch.setattr(ops.backend(gb), "device_type", None)  # `cuda` on CPU tensors
    a, b = _operands(m=8, k=16, n=8, seed=5)
    ga, gb_ = _grouped_operands(g=2, m=4, k=16, n=8, seed=5)
    for fn, (x, y) in ((ops.matmul, (a, b)), (ops.grouped_matmul, (ga, gb_))):
        tx, ty = _t(x, y, grad=True)
        got = torch.autograd.grad(fn(tx, ty, backend=name, epilogue="silu").sum(), (tx, ty))
        want = torch.autograd.grad(fn(tx, ty, backend=gb, epilogue="silu").sum(), (tx, ty))
        for u, v in zip(got, want):
            assert torch.equal(u, v)
    q = QuantizedTensor(torch.ones((8, 16), dtype=torch.int8), torch.tensor(0.5))
    with pytest.raises(NotImplementedError, match="serving-only"):
        ops.matmul(q, _t(b, grad=True), backend=name)


# --- the grouped member -------------------------------------------------------


def test_every_builtin_declares_a_grouped_member_and_fuses():
    for n in ALL_BACKENDS:
        be = ops.backend(n)
        assert be.grouped_fn is not None and be.epilogue_fused, n


@_over_backends
def test_grouped_equals_stacked_matmul(name):
    a, b = _grouped_operands()
    got = ops.grouped_matmul(*_t(a, b), backend=name)
    want = torch.stack([ops.matmul(*_t(a[i], b[i]), backend=name) for i in range(a.shape[0])])
    tol = 1e-5 if ops.family_of(name) == "fp" else 1e-4 * float(want.abs().max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=max(tol, 1e-5))
    _jax_close(name, got, jops.grouped_matmul(jnp.asarray(a), jnp.asarray(b),
                                              backend=_jmember(name)))


@_over_backends
def test_grouped_bias_rides_the_backend(name):
    a, b = _grouped_operands(seed=5)
    bias = np.random.default_rng(6).standard_normal((a.shape[0], b.shape[2])).astype(np.float32)
    no_bias = ops.grouped_matmul(*_t(a, b), backend=name)
    with_bias = ops.grouped_matmul(*_t(a, b, bias), backend=name)
    np.testing.assert_allclose(_np(with_bias), _np(no_bias) + bias[:, None, :],
                               rtol=1e-6, atol=1e-6)
    _jax_close(name, with_bias, jops.grouped_matmul(*map(jnp.asarray, (a, b, bias)),
                                                    backend=_jmember(name)))


@_over_backends
def test_grouped_gradients_match_reference(name):
    a, b = _grouped_operands(g=2, m=16, k=32, n=24, seed=7)
    ta, tb = _t(a, b, grad=True)
    out = ops.grouped_matmul(ta, tb, backend=name)
    assert isinstance(out.grad_fn, ops._GroupedMatmul._backward_cls)
    da, db = torch.autograd.grad(out.sum(), (ta, tb))
    want = jax.grad(lambda a, b: reference_grouped_matmul(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    for x, y in zip((da, db), want):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-4, atol=1e-4)


# --- the epilogue contract (backend x epilogue x lane) -----------------------

# Each case: (spec builder over operands, independent torch reference on the
# fp32 accumulator). The references are hand-written, sharing no code with
# repro_torch.kernels.epilogue.


def _epilogue_cases(m, n, seed=11, groups=0):
    rng = np.random.default_rng(seed)
    lead = (groups,) if groups else ()
    row = lambda: rng.standard_normal(lead + (n,)).astype(np.float32)  # noqa: E731
    full = lambda: rng.standard_normal(lead + (m, n)).astype(np.float32)  # noqa: E731
    bias, resid, gate, sc = row(), full(), full(), row()
    s = np.float32(0.05)
    r = (lambda x: torch.from_numpy(x)[:, None, :]) if groups else (
        lambda x: torch.from_numpy(x)[None, :])
    f = torch.from_numpy
    gelu = lambda x: torch.nn.functional.gelu(x, approximate="tanh")  # noqa: E731
    return {
        "gelu": ("gelu", gelu),
        "silu": ("silu", torch.nn.functional.silu),
        "swish": ("swish", torch.nn.functional.silu),
        "relu": ("relu", lambda x: torch.clamp_min(x, 0.0)),
        "bias": ([("bias", bias)], lambda x: x + r(bias)),
        "residual": ([("residual", resid)], lambda x: x + f(resid)),
        "mul": ([("mul", gate)], lambda x: x * f(gate)),
        "scale": ([("scale", sc)], lambda x: x * r(sc)),
        "requant_int8": ([("requant_int8", s)],
                         lambda x: torch.clamp(torch.round(x / float(s)), -127, 127)),
        "silu-mul": (["silu", ("mul", gate)], lambda x: torch.nn.functional.silu(x) * f(gate)),
        "bias-gelu": ([("bias", bias), "gelu"], lambda x: gelu(x + r(bias))),
    }


EPILOGUE_IDS = sorted(_epilogue_cases(1, 1))
LANES = ["fused", "post-hoc"]


def _lane(monkeypatch, name, lane):
    if lane == "post-hoc":
        monkeypatch.setattr(ops.backend(name), "epilogue_fused", False)


def _tspec(spec):
    """A spec with its numpy operands as tensors (the port's side)."""
    if isinstance(spec, str):
        return spec
    return [s if isinstance(s, str) else (s[0], torch.tensor(s[1])) for s in spec]


def _jspec(spec):
    if isinstance(spec, str):
        return spec
    return [s if isinstance(s, str) else (s[0], jnp.asarray(s[1])) for s in spec]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("ep", EPILOGUE_IDS)
@_over_backends
def test_epilogue_matches_reference(name, ep, lane, monkeypatch):
    _lane(monkeypatch, name, lane)
    a, b = _operands(seed=10)
    spec, ref_fn = _epilogue_cases(a.shape[0], b.shape[1])[ep]
    acc = ops.matmul(*_t(a, b), backend=name, out_dtype=torch.float32)
    got = ops.matmul(*_t(a, b), backend=name, epilogue=_tspec(spec), out_dtype=torch.float32)
    # This backend's accumulator through independent post-ops: the same
    # fp32 accumulator either way, only op-level rounding differs.
    np.testing.assert_allclose(_np(got), _np(ref_fn(acc)), rtol=1e-5, atol=1e-5)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), backend=_jmember(name),
                       epilogue=_jspec(spec), out_dtype=jnp.float32)
    _jax_close(name, got, want, extra=1.0 if ep == "requant_int8" else 0.0)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("ep", EPILOGUE_IDS)
@_over_backends
def test_epilogue_single_final_cast(name, ep, lane, monkeypatch):
    _lane(monkeypatch, name, lane)
    a, b = _operands(seed=12)
    spec, _ = _epilogue_cases(a.shape[0], b.shape[1])[ep]
    wide = ops.matmul(*_t(a, b), backend=name, epilogue=_tspec(spec), out_dtype=torch.float32)
    narrow = ops.matmul(*_t(a, b), backend=name, epilogue=_tspec(spec),
                        out_dtype=torch.bfloat16)
    assert narrow.dtype == torch.bfloat16
    assert torch.equal(narrow, wide.to(torch.bfloat16))


@pytest.mark.parametrize("lane", LANES)
@_over_backends
def test_epilogue_vjp_matches_unfused(name, lane, monkeypatch):
    """Gradients through the chain equal those of the unfused fp32
    composition, the epilogue operand's cotangent included."""
    _lane(monkeypatch, name, lane)
    a, b = _operands(m=24, k=48, n=32, seed=13)
    gate = np.random.default_rng(14).standard_normal((24, 32)).astype(np.float32)
    ta, tb, tg = _t(a, b, gate, grad=True)
    # Every family: the backward recomputes the accumulator on the fp grad
    # backend, so even a q8 forward differentiates the fp composition.
    out = ops.matmul(ta, tb, backend=name, epilogue=["silu", ("mul", tg)])
    got = torch.autograd.grad(out.sum(), (ta, tb, tg))
    want = jax.grad(lambda a, b, g: (jax.nn.silu(reference_matmul(a, b)) * g).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, gate)))
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ep", EPILOGUE_IDS)
@_over_backends
def test_grouped_epilogue_matches_stacked(name, ep):
    """Every epilogue op on the grouped member: equal to the 2-D member per
    group on the group's operand slices, and to the JAX family member."""
    a, b = _grouped_operands(seed=15)
    g_, m, n = a.shape[0], a.shape[1], b.shape[2]
    spec, _ = _epilogue_cases(m, n, seed=16, groups=g_)[ep]

    def slice_spec(i):
        if isinstance(spec, str):
            return spec
        return [s if isinstance(s, str) else
                (s[0], torch.tensor(s[1] if np.ndim(s[1]) == 0 else s[1][i])) for s in spec]

    got = ops.grouped_matmul(*_t(a, b), backend=name, epilogue=_tspec(spec),
                             out_dtype=torch.float32)
    want = torch.stack([ops.matmul(*_t(a[i], b[i]), backend=name, epilogue=slice_spec(i),
                                   out_dtype=torch.float32) for i in range(g_)])
    tol = 1e-5 if ops.family_of(name) == "fp" else 1e-4 * float(want.abs().max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=max(tol, 1e-5))
    j = jops.grouped_matmul(jnp.asarray(a), jnp.asarray(b), backend=_jmember(name),
                            epilogue=_jspec(spec), out_dtype=jnp.float32)
    _jax_close(name, got, j, extra=1.0 if ep == "requant_int8" else 0.0)


# --- resolution ------------------------------------------------------------------


def _register(monkeypatch, name, fn, **kw):
    monkeypatch.setitem(ops._REGISTRY, name, ops._REGISTRY.get(name))  # undone at teardown
    ops.register_backend(name, fn, **kw)


def test_resolution_never_crosses_family_boundaries(monkeypatch):
    # The automatic picks stay inside their family on both device types,
    # and registered backends never enter them.
    _register(monkeypatch, "_test_fp_any", ops.backend("torch").fn)
    for dev in ("cpu", "cuda"):
        assert ops.family_of(ops.resolve_backend(None, torch.device(dev))) == "fp"
        assert ops.family_of(ops.resolve_backend("auto", torch.device(dev))) == "fp"
        assert ops.family_of(ops.resolve_backend("q8", torch.device(dev))) == "q8"
    assert ops.resolve_backend(None, torch.device("cpu")) == "torch"
    # A q8 member bound to the card never lands on another member for CPU
    # tensors: it raises.
    _register(monkeypatch, "_test_q8_card", q8b.cuda_q8, grouped=q8b.cuda_q8_grouped,
              device_type="cuda", family="q8", grad_backend="cuda", epilogue_fused=True)
    a, b = _operands(m=4, k=8, n=4)
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        ops.matmul(*_t(a, b), backend="_test_q8_card")
    with pytest.raises(ValueError, match="unknown matmul backend"):
        ops.resolve_backend("_test_missing", torch.device("cpu"))


def test_grouped_resolution_never_crosses_family_boundaries(monkeypatch):
    # A q8 member without a grouped member raises on grouped_matmul, never
    # handing the request to an fp grouped GEMM; its 2-D member still runs.
    _register(monkeypatch, "_test_q8_no_grouped", q8b.torch_q8, family="q8",
              grad_backend="torch", epilogue_fused=True)
    a, b = _operands(m=4, k=8, n=4)
    ga, gb = _grouped_operands(g=2, m=4, k=8, n=4)
    got = ops.matmul(*_t(a, b), backend="_test_q8_no_grouped")
    assert torch.equal(got, ops.matmul(*_t(a, b), backend="torch_q8"))
    with pytest.raises(ValueError, match="no grouped member"):
        ops.grouped_matmul(*_t(ga, gb), backend="_test_q8_no_grouped")


def test_register_backend_replaces_and_validates(monkeypatch):
    seen = []
    real = ops.backend("torch").fn

    def plain(a, b, c=None, *, out_dtype=None):
        seen.append(out_dtype)
        return real(a, b, c, out_dtype=out_dtype)

    _register(monkeypatch, "torch", plain, grouped=opope_gemm_grouped_plain)
    be = ops.backend("torch")
    assert (be.fn, be.family, be.grad_backend, be.epilogue_fused, be.device_type) == (
        plain, "fp", None, False, None)
    a, b = _operands(m=4, k=8, n=4)
    ops.matmul(*_t(a, b), epilogue="relu", out_dtype=torch.bfloat16)  # None -> "torch"
    assert seen == [torch.float32]  # not fused: fp32 product, the chain, one cast
    with pytest.raises(TypeError, match="not callable"):
        ops.register_backend("_test_bad", None)


# --- ops registered at run time ------------------------------------------------


def _softsign(acc, _o):
    return acc / (1.0 + acc.abs())


def _j_softsign(acc, _o):
    return acc / (1.0 + jnp.abs(acc))


def _silu_scaled(acc, _o):
    return 2.0 * acc * torch.sigmoid(acc)


def _j_silu_scaled(acc, _o):
    return 2.0 * jax.nn.silu(acc)


RUNTIME_OPS = {"new": ("_test_softsign", _softsign, _j_softsign),
               "replaces-silu": ("silu", _silu_scaled, _j_silu_scaled)}


def _register_both(monkeypatch, which):
    op, fn, jfn = RUNTIME_OPS[which]
    for reg, register, f in ((tep._REGISTRY, tep.register_epilogue_op, fn),
                             (jep._REGISTRY, jep.register_epilogue_op, jfn)):
        monkeypatch.setitem(reg, op, reg.get(op))  # restored (or removed) at teardown
        register(op, "none", f)
    return op


def _no_codeless_op_in_any_call(monkeypatch, name):
    """Wrap the backend's two members: a call that carries a chain must not
    carry an op without a kernel code."""
    be = ops.backend(name)
    calls = []
    for attr in ("fn", "grouped_fn"):
        real = getattr(be, attr)

        def spy(*args, _real=real, **kw):
            steps = kw.get("epilogue", ())
            calls.append(tuple(steps))
            assert tep.fusable(steps), f"{name}: code-less op reached the backend: {steps}"
            return _real(*args, **kw)

        monkeypatch.setattr(be, attr, spy)
    return calls


@pytest.mark.parametrize("which", sorted(RUNTIME_OPS))
@_over_backends
def test_runtime_op_runs_post_hoc_and_matches_the_reference(name, which, monkeypatch):
    op = _register_both(monkeypatch, which)
    assert tep.op_def(op).code is None and not tep.fusable((op,))
    assert tep.OP_CODES["silu"] == 1  # the kernels' enum keeps its built-ins
    a, b = _operands(seed=20)
    ga, gb = _grouped_operands(seed=21)
    resid = np.random.default_rng(22).standard_normal((a.shape[0], b.shape[1])).astype(np.float32)
    calls = _no_codeless_op_in_any_call(monkeypatch, name)
    spec = [op, ("residual", torch.tensor(resid))]
    for out_dtype in (torch.float32, torch.bfloat16):
        got = ops.matmul(*_t(a, b), backend=name, epilogue=spec, out_dtype=out_dtype)
        acc = ops.matmul(*_t(a, b), backend=name, out_dtype=torch.float32)
        post = tep.apply_epilogue(acc, (op, "residual"), (torch.tensor(resid),)).to(out_dtype)
        assert torch.equal(got, post)
        g_got = ops.grouped_matmul(*_t(ga, gb), backend=name, epilogue=op, out_dtype=out_dtype)
        g_acc = ops.grouped_matmul(*_t(ga, gb), backend=name, out_dtype=torch.float32)
        assert torch.equal(g_got, tep.apply_epilogue(g_acc, (op,), ()).to(out_dtype))
    assert calls and all(steps == () for steps in calls)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), backend=_jmember(name),
                       epilogue=[op, ("residual", jnp.asarray(resid))], out_dtype=jnp.float32)
    _jax_close(name, ops.matmul(*_t(a, b), backend=name, out_dtype=torch.float32,
                                epilogue=spec), want)
    g_want = jops.grouped_matmul(jnp.asarray(ga), jnp.asarray(gb), backend=_jmember(name),
                                 epilogue=op, out_dtype=jnp.float32)
    _jax_close(name, ops.grouped_matmul(*_t(ga, gb), backend=name, epilogue=op,
                                        out_dtype=torch.float32), g_want)


@pytest.mark.parametrize("which", sorted(RUNTIME_OPS))
@_over_backends
def test_runtime_op_vjp_matches_the_reference(name, which, monkeypatch):
    op = _register_both(monkeypatch, which)
    a, b = _operands(m=12, k=16, n=8, seed=23)
    ga, gb = _grouped_operands(g=2, m=6, k=16, n=8, seed=24)
    for grouped, (x, y) in ((False, (a, b)), (True, (ga, gb))):
        f_t = ops.grouped_matmul if grouped else ops.matmul
        f_j = jops.grouped_matmul if grouped else jops.matmul
        tx, ty = _t(x, y, grad=True)
        got = torch.autograd.grad(f_t(tx, ty, backend=name, epilogue=op).sum(), (tx, ty))
        want = jax.grad(lambda p, q: f_j(p, q, backend="xla", epilogue=op).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        for u, v in zip(got, want):
            _jax_close(name, u, v)


def test_epilogue_struct_refuses_an_op_without_a_kernel_code(monkeypatch):
    """No code-less op reaches the kernels' by-value chain (K1, K2, K4 and
    K5 all build it here); the built-ins keep their enum codes."""
    _register_both(monkeypatch, "new")
    shapes = {"scalar": (1, 1), "row": (1, 4), "full": (2, 4)}
    ep = _epilogue_struct(("silu", "relu"), (), shapes)
    assert (ep.n_steps, ep.op[0], ep.op[1]) == (2, tep.OP_CODES["silu"], tep.OP_CODES["relu"])
    with pytest.raises(ValueError, match="no kernel code"):
        _epilogue_struct(("silu", "_test_softsign"), (), shapes)
    _register_both(monkeypatch, "replaces-silu")
    with pytest.raises(ValueError, match="no kernel code"):
        _epilogue_struct(("silu",), (), shapes)


def test_register_epilogue_op_validates():
    with pytest.raises(ValueError, match="kind"):
        tep.register_epilogue_op("_test_bad", "matrix", _softsign)
    with pytest.raises(TypeError, match="not callable"):
        tep.register_epilogue_op("_test_bad", "none", None)
    assert "_test_bad" not in tep.epilogue_ops()
