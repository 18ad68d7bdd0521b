"""The port's int8 stack against the JAX reference, on the CPU: quantizers,
precision policies, the int8 O-POPE GEMMs (K2, K5) and the q8 backends.

Inputs are numpy draws from fixed seeds, handed to both packages. Exact
arithmetic is held **bitwise**: the quantizers (values, fp8 bit patterns and
scales) against ``repro.quant.quantize``; the ``torch_q8`` backend against
the reference's ``xla_q8`` for dense and grouped GEMMs with no C, a bias
row, a full C and every chain without a transcendental op, and on the
pre-quantized A lane; ``torch_q8`` and the plain versions of K2 and K5
against ``pallas_q8_interpret`` (the Pallas kernels in interpret mode).

One difference between the reference's two lanes is held exactly as it is:
inside the interpret-mode kernel, XLA on the CPU contracts the dequant
multiply and the next add (a C preload, a ``bias`` or a ``residual`` step)
into one fused multiply-add, one rounding where ``xla_q8`` (and the port, on
the CPU and in the CUDA kernels) rounds the product and the sum apart. The
reference's own test allows this (``tests/test_quant.py``, rtol 1e-6). For
such chains the interpret-mode output is held bitwise against the port's
arithmetic with that one add fused (an fp64 emulation of the FMA), which
shows the contraction is the whole difference.

Chains with ``silu`` or ``gelu`` agree within ``SILU_GELU_ULPS`` fp32 ulps
of the largest pre-activation: the two packages compute the activations by
other formulas (torch ``x / (1 + exp(-x))``, JAX ``x * sigmoid(x)``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.kernels import ops as jops
from repro.quant import pallas_q8 as jpq
from repro_torch import quant as tq
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import ops as tops
from repro_torch.quant import backends as tqb

SILU_GELU_ULPS = 8
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _bits(x):
    """A tensor or array's values as raw bytes (fp8 and int8 alike)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _equal_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tuple(got.shape) == tuple(np.shape(want))


def _pair(x, dtype="float32"):
    """The same numpy values on both sides, in fp32 or bf16 (rounded once,
    to nearest even, from the same fp32 values)."""
    j, t = jnp.asarray(x, jnp.float32), torch.from_numpy(np.asarray(x, np.float32))
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape,axis", [((12, 40), None), ((12, 40), 0), ((12, 40), 1),
                                        ((3, 7, 20), (0, 1)), ((3, 7, 20), (0, 2))],
                         ids=["tensor", "axis0", "axis1", "axis01", "axis02"])
def test_quantize_is_bitwise_the_reference(shape, axis, fmt, dtype):
    x = _rng(0).standard_normal(shape) * 3.0
    x[0] = 0.0  # an all-zero row / group slice
    jx, tx = _pair(x, dtype)
    want, got = jq.quantize(jx, fmt, axis=axis), tq.quantize(tx, fmt, axis=axis)
    _equal_bits(got.q, want.q)
    _equal_bits(got.scale, want.scale)
    assert got.fmt.name == fmt and got.scale.dtype == torch.float32
    _equal_bits(got.dequantize(), jq.dequantize(want))


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_all_zero_tensor_quantizes_to_zeros_with_the_floor_scale(fmt):
    jx, tx = _pair(np.zeros((4, 6)))
    want, got = jq.quantize(jx, fmt, axis=1), tq.quantize(tx, fmt, axis=1)
    _equal_bits(got.q, want.q)
    _equal_bits(got.scale, want.scale)
    assert not got.q.float().any() and torch.isfinite(got.scale).all()


@pytest.mark.parametrize("axis", [None, 1])
def test_calibrate_scale_and_fixed_scale_quantization_match(axis):
    batches = [_rng(i).standard_normal((8, 16)) * (i + 1) for i in range(3)]
    for margin in (1.0, 1.25):
        want = jq.calibrate_scale([jnp.asarray(b, jnp.float32) for b in batches], "int8",
                                  axis=axis, margin=margin)
        got = tq.calibrate_scale([torch.from_numpy(b.astype(np.float32)) for b in batches],
                                 "int8", axis=axis, margin=margin)
        _equal_bits(got, want)
    # A fixed scale clips what the calibration never saw.
    x = _rng(9).standard_normal((8, 16)) * 10
    jx, tx = _pair(x)
    _equal_bits(tq.quantize_with_scale(tx, got).q, jq.quantize_with_scale(jx, want).q)
    with pytest.raises(ValueError, match="no batches"):
        tq.calibrate_scale([])


def test_format_lookup():
    assert tq.format_of("int8") is tq.FORMATS["int8"]
    assert tq.format_of(torch.float8_e5m2).name == "fp8_e5m2"
    assert [f.qmax for f in tq.FORMATS.values()] == [f.qmax for f in jq.FORMATS.values()]
    with pytest.raises(ValueError, match="unknown quant format"):
        tq.format_of("int4")
    q = tq.quantize(torch.ones(4, 4), "int8")
    assert q.nbytes == 16 + 4


# ---------------------------------------------------------------------------
# precision policies
# ---------------------------------------------------------------------------


def test_policy_rejects_unknown_roles():
    with pytest.raises(ValueError, match="unknown roles"):
        tq.PrecisionPolicy(rules={"flux_capacitor": "q8"})
    with pytest.raises(ValueError, match="requant roles"):
        tq.PrecisionPolicy(requant={"nonsense": 0.1})


def test_policy_role_resolution_matches_the_reference():
    assert tq.ROLES == jq.ROLES
    for moe in (True, False):
        for rq in (None, 0.25):
            got, want = tq.mlp_q8_policy(moe=moe, requant_scale=rq), \
                jq.mlp_q8_policy(moe=moe, requant_scale=rq)
            for role in tq.ROLES:
                # The reference resolves "q8" by probing (xla_q8 here); the
                # port leaves it to ops.resolve_backend, by device.
                assert (got.backend_for(role) is None) == (want.backend_for(role) is None)
                assert got.requant_for(role) == want.requant_for(role)
            assert got.name == want.name
    pol = tq.mlp_q8_policy()
    assert pol.backend_for("mlp") == pol.backend_for("moe") == "q8"
    assert pol.backend_for("attn_qkv") is None and pol.backend_for("router") is None
    assert pol.describe() == {"attn_qkv": "<default>", "attn_out": "<default>", "mlp": "q8",
                              "moe": "q8", "router": "<default>", "mixer": "<default>"}
    assert tops.resolve_backend(pol.backend_for("mlp"), torch.device("cpu")) == "torch_q8"
    assert tops.resolve_backend("q8", torch.device("cuda")) == "cuda_q8"


def test_q8_backends_are_registered_without_fallback():
    assert {"cuda_q8", "torch_q8"} <= set(tops.registered_backends())
    for name, grad in (("cuda_q8", "cuda"), ("torch_q8", "torch")):
        assert tops.family_of(name) == "q8" and tops.backend(name).grad_backend == grad
    assert tops.family_of("cuda") == tops.family_of("torch") == "fp"
    with pytest.raises(ValueError, match="runs on cuda"):
        tops.matmul(torch.ones(2, 8), torch.ones(8, 4), backend="cuda_q8")
    with pytest.raises(ValueError, match="unknown matmul backend"):
        tops.family_of("xla_q8")


# ---------------------------------------------------------------------------
# torch_q8 against xla_q8 / pallas_q8_interpret
# ---------------------------------------------------------------------------

M, K, N, G = 6, 40, 24, 3
BITWISE_CHAINS = ["none", "bias", "full-c", "residual", "mul", "scale", "bias+relu+mul",
                  "requant_int8"]


def _chain(name, rng, lead, n, groups=0):
    """(c, epilogue spec, out dtypes) of a named chain, as numpy operands."""
    full = rng.standard_normal(lead + (n,)).astype(np.float32)
    row = rng.standard_normal(((groups, n) if groups else (n,))).astype(np.float32)
    return {
        "none": (None, None),
        "bias": (row, None),
        "full-c": (full, None),
        "residual": (None, [("residual", full)]),
        "mul": (None, [("mul", full)]),
        "scale": (None, [("scale", row)]),
        "bias+relu+mul": (row, ["relu", ("mul", full)]),
        "requant_int8": (None, [("mul", full), ("requant_int8", np.float32(0.05))]),
        "silu+mul": (None, ["silu", ("mul", full)]),
        "gelu": (full, ["gelu"]),
    }[name]


def _to_j(spec):
    return None if spec is None else [
        s if isinstance(s, str) else (s[0], jnp.asarray(s[1])) for s in spec]


def _to_t(spec):
    return None if spec is None else [
        s if isinstance(s, str) else (s[0], torch.as_tensor(s[1])) for s in spec]


def _run_both(grouped, jbackend, a, b, c, spec, out):
    jfn, tfn = (jops.grouped_matmul, tops.grouped_matmul) if grouped else \
        (jops.matmul, tops.matmul)
    jout = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}[out]
    tout = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}[out]
    want = jfn(jnp.asarray(a), jnp.asarray(b), None if c is None else jnp.asarray(c),
               backend=jbackend, out_dtype=jout, epilogue=_to_j(spec))
    got = tfn(torch.from_numpy(a), torch.from_numpy(b), None if c is None else
              torch.from_numpy(c), backend="torch_q8", out_dtype=tout, epilogue=_to_t(spec))
    return got, want


def _outs(chain):
    return ["int8"] if chain == "requant_int8" else ["float32", "bfloat16"]


def _assert_activation_close(got, want, a, b):
    """Within SILU_GELU_ULPS fp32 ulps of the largest pre-activation."""
    acc = np.abs(np.matmul(a, b)).max()
    tol = SILU_GELU_ULPS * F32_EPS * max(1.0, float(acc))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=tol if want.dtype == jnp.float32 else tol + 2.0 ** -8 * float(
                                   np.abs(np.asarray(want, np.float32)).max()))


# Chains whose first step after the dequant multiply is an add.
ADD_CHAINS = ("bias", "full-c", "residual", "bias+relu+mul")
TORCH_OUT = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _fused_first_add(acc, s, addend, steps, operands, out_dtype):
    """The q8 writeback with the dequant multiply and the first add fused
    into one rounding (``acc * s`` is exact in fp64; so is the sum up to
    one fp64 rounding), then the rest of the chain in fp32, one cast."""
    x = (acc.double() * s.double() + addend.double()).float()
    return tep.apply_epilogue(x, steps, operands).to(out_dtype)


def _contracted(grouped, a, b, c, spec, out):
    """torch_q8's result on (a, b, c, spec) with its first add fused."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    aq, bq = (tqb.quantize_grouped_operands(ta, tb) if grouped else
              tqb.quantize_operands(ta, tb))
    acc = torch.matmul(aq.q.int(), bq.q.int())
    steps = [] if spec is None else [x if isinstance(x, str) else x[0] for x in spec]
    operands = [] if spec is None else [torch.as_tensor(x[1]) for x in spec
                                        if not isinstance(x, str)]
    if c is not None:
        addend = torch.from_numpy(c)
        if grouped and c.ndim == 2:
            addend = addend[:, None, :]
    else:
        assert steps[0] == "residual"
        addend, steps, operands = operands[0], steps[1:], operands[1:]
    return _fused_first_add(acc, aq.scale * bq.scale, addend, tuple(steps),
                            tuple(operands), TORCH_OUT[out])


def _gemm_case(grouped, chain, seed):
    rng = _rng(seed)
    lead = (G, M) if grouped else (M,)
    a = rng.standard_normal(lead + (K,)).astype(np.float32)
    if grouped:
        a[1] = 0.0  # an expert that got no tokens (zero capacity rows)
    b = (rng.standard_normal(((G,) if grouped else ()) + (K, N)) * K ** -0.5).astype(np.float32)
    c, spec = _chain(chain, rng, lead, N, groups=G if grouped else 0)
    return a, b, c, spec


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
@pytest.mark.parametrize("chain", BITWISE_CHAINS + ["silu+mul", "gelu"])
def test_torch_q8_matches_xla_q8(chain, grouped):
    a, b, c, spec = _gemm_case(grouped, chain, 10 + grouped)
    for out in _outs(chain):
        got, want = _run_both(grouped, "xla_q8", a, b, c, spec, out)
        if chain in BITWISE_CHAINS:
            _equal_bits(got, want)
        else:
            _assert_activation_close(got, want, a, b)


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
@pytest.mark.parametrize("chain", BITWISE_CHAINS + ["silu+mul", "gelu"])
def test_torch_q8_matches_pallas_q8_interpret(chain, grouped):
    a, b, c, spec = _gemm_case(grouped, chain, 10 + grouped)
    for out in _outs(chain):
        got, want = _run_both(grouped, "pallas_q8_interpret", a, b, c, spec, out)
        if chain in ADD_CHAINS:
            _equal_bits(_contracted(grouped, a, b, c, spec, out), want)
        elif chain in BITWISE_CHAINS:
            _equal_bits(got, want)
        else:
            _assert_activation_close(got, want, a, b)


def test_grouped_row_operand_may_be_shared_by_all_groups():
    rng = _rng(12)
    a = rng.standard_normal((G, M, K)).astype(np.float32)
    b = rng.standard_normal((G, K, N)).astype(np.float32)
    row = rng.standard_normal((N,)).astype(np.float32)
    got, want = _run_both(True, "xla_q8", a, b, None, [("scale", row), ("bias", row)], "float32")
    _equal_bits(got, want)


@pytest.mark.parametrize("per_row", [False, True], ids=["tensor-scale", "row-scales"])
def test_prequantized_a_lane_is_bitwise(per_row):
    rng = _rng(13)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    w1 = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((N, K)) * N ** -0.5).astype(np.float32)
    up = rng.standard_normal((2, 3, N)).astype(np.float32)
    res = rng.standard_normal((2, 3, K)).astype(np.float32)
    s = np.float32(0.02)
    # The requant writeback (int8 on the grid of s), then the next GEMM
    # consuming it pre-quantized.
    spec = [("mul", up), ("requant_int8", s)]
    jh = jops.matmul(jnp.asarray(x), jnp.asarray(w1), backend="xla_q8", out_dtype=jnp.int8,
                     epilogue=_to_j(spec))
    th = tops.matmul(torch.from_numpy(x), torch.from_numpy(w1), backend="torch_q8",
                     out_dtype=torch.int8, epilogue=_to_t(spec))
    _equal_bits(th, jh)
    scale = (rng.uniform(0.01, 0.03, (2, 3)).astype(np.float32) if per_row else s)
    want = jops.matmul(jq.QuantizedTensor(jh, jnp.asarray(scale)), jnp.asarray(w2),
                       backend="xla_q8", epilogue=[("residual", jnp.asarray(res))])
    got = tops.matmul(tq.QuantizedTensor(th, torch.as_tensor(scale)), torch.from_numpy(w2),
                      backend="torch_q8", epilogue=[("residual", torch.from_numpy(res))])
    assert got.dtype == torch.float32  # pre-quantized A defaults to fp32 out
    _equal_bits(got, want)
    with pytest.raises(ValueError, match="q8-family"):
        tops.matmul(tq.QuantizedTensor(th, torch.as_tensor(s)), torch.from_numpy(w2),
                    backend="torch")


# ---------------------------------------------------------------------------
# K2 / K5 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _int8(rng, shape, zero_rows=()):
    q = rng.integers(-127, 128, shape).astype(np.int8)
    for r in zero_rows:
        q[..., r, :] = 0
    return q


@pytest.mark.parametrize("shape", [(5, 40, 24), (33, 70, 130)], ids=["5x40x24", "33x70x130"])
@pytest.mark.parametrize("c_kind", ["none", "row", "full"])
def test_k2_plain_matches_the_pallas_kernel(shape, c_kind):
    m, k, n = shape
    rng = _rng(m + k + n)
    aq, bq = _int8(rng, (m, k)), _int8(rng, (k, n))
    sa = rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    c = {"none": None, "row": rng.standard_normal(n).astype(np.float32),
         "full": rng.standard_normal((m, n)).astype(np.float32)}[c_kind]
    full = rng.standard_normal((m, n)).astype(np.float32)
    for steps, operands in (((), ()), (("residual", "relu"), (full,))):
        want = jpq.opope_gemm_q8(jnp.asarray(aq), jnp.asarray(sa), jnp.asarray(bq),
                                 jnp.asarray(sb), None if c is None else jnp.asarray(c),
                                 interpret=True, epilogue=steps,
                                 epilogue_operands=tuple(jnp.asarray(x) for x in operands))
        got = tq.opope_gemm_q8_plain(
            torch.from_numpy(aq), torch.from_numpy(sa), torch.from_numpy(bq),
            torch.from_numpy(sb), None if c is None else torch.from_numpy(c),
            epilogue=steps, epilogue_operands=tuple(torch.from_numpy(x) for x in operands))
        if c is None and not steps:
            _equal_bits(got, want)
        else:  # an add follows the dequant: interpret mode fuses it (see top)
            acc = torch.from_numpy(aq).int() @ torch.from_numpy(bq).int()
            addend = torch.from_numpy(c if c is not None else full)
            rest = steps if c is not None else steps[1:]
            _equal_bits(_fused_first_add(acc, torch.from_numpy(sa) * torch.from_numpy(sb),
                                         addend, rest, tuple(torch.from_numpy(x) for x in
                                                             operands[len(steps) - len(rest):]),
                                         torch.float32), want)
        # The wrapper takes the plain version for tensors on the CPU.
        assert torch.equal(got, tq.opope_gemm_q8(
            torch.from_numpy(aq), torch.from_numpy(sa), torch.from_numpy(bq),
            torch.from_numpy(sb), None if c is None else torch.from_numpy(c),
            epilogue=steps, epilogue_operands=tuple(torch.from_numpy(x) for x in operands)))


@pytest.mark.parametrize("c_kind", ["none", "row", "full"])
def test_k5_plain_matches_the_pallas_kernel(c_kind):
    g, m, k, n = 3, 5, 72, 40
    rng = _rng(c_kind == "row")
    aq, bq = _int8(rng, (g, m, k), zero_rows=(1,)), _int8(rng, (g, k, n))
    sa = rng.uniform(1e-3, 1e-1, (g, m, 1)).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-1, (g, 1, n)).astype(np.float32)
    c = {"none": None, "row": rng.standard_normal((g, n)).astype(np.float32),
         "full": rng.standard_normal((g, m, n)).astype(np.float32)}[c_kind]
    want = jpq.opope_gemm_q8_grouped(jnp.asarray(aq), jnp.asarray(sa), jnp.asarray(bq),
                                     jnp.asarray(sb), None if c is None else jnp.asarray(c),
                                     interpret=True)
    ta, tsa, tb, tsb = (torch.from_numpy(x) for x in (aq, sa, bq, sb))
    got = tq.opope_gemm_q8_grouped_plain(ta, tsa, tb, tsb,
                                         None if c is None else torch.from_numpy(c))
    if c is None:
        _equal_bits(got, want)
    else:  # interpret mode fuses the C add into the dequant multiply (see top)
        addend = torch.from_numpy(c)[:, None, :] if c.ndim == 2 else torch.from_numpy(c)
        _equal_bits(_fused_first_add(torch.bmm(ta.int(), tb.int()), tsa * tsb, addend, (), (),
                                     torch.float32), want)
    if c is None:  # an all-zero A row gives an exactly zero output row
        assert not got[:, 1].any()


def test_decode_capacity_rows_of_zeros_give_exact_zeros():
    # K5 at decode: M = 1 row per expert; an expert no token reached holds
    # a zero row, scale 1e-12 / 127 and q = 0, so its output is exactly 0.
    rng = _rng(14)
    x = rng.standard_normal((4, 1, 32)).astype(np.float32)
    x[[0, 2]] = 0.0
    w = rng.standard_normal((4, 32, 16)).astype(np.float32)
    got, want = _run_both(True, "xla_q8", x, w, None, None, "float32")
    _equal_bits(got, want)
    assert not got[[0, 2]].any() and got[[1, 3]].all()
    aq, _ = tqb.quantize_grouped_operands(torch.from_numpy(x), torch.from_numpy(w))
    assert float(aq.scale[0, 0, 0]) == np.float32(np.float32(1e-12) / np.float32(127.0))


def test_shapes_and_accumulator_range_are_checked():
    a, s1 = torch.zeros((2, 8), dtype=torch.int8), torch.ones((2, 1))
    b, s2 = torch.zeros((8, 4), dtype=torch.int8), torch.ones((1, 4))
    with pytest.raises(ValueError, match="a_scale shape"):
        tq.opope_gemm_q8(a, torch.ones((1, 2)), b, s2)
    with pytest.raises(ValueError, match="b_scale shape"):
        tq.opope_gemm_q8(a, s1, b, torch.ones((4,)))
    with pytest.raises(ValueError, match="requant_int8"):
        tq.opope_gemm_q8(a, s1, b, s2, out_dtype=torch.int8)
    k = tq.MAX_K + 1
    assert tq.MAX_K * 127 * 127 < 2**31 <= k * 127 * 127
    with pytest.raises(ValueError, match="overflow"):
        tq.opope_gemm_q8(torch.zeros((1, k), dtype=torch.int8), torch.ones((1, 1)),
                         torch.zeros((k, 1), dtype=torch.int8), torch.ones((1, 1)))
    with pytest.raises(ValueError, match="a_scale shape"):
        tq.opope_gemm_q8_grouped(a[None], s1, b[None], s2[None])
