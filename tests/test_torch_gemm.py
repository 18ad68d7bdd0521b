"""The port's GEMM layer against the JAX reference, on the CPU.

The port's ``matmul``/``linear`` (plain PyTorch backend: CPU tensors) and the
JAX package's Pallas kernel ``opope_gemm`` run in interpret mode, and its
oracle ``reference_matmul``, get the same numpy inputs. Tolerances:

* fp32 out: rtol 1e-5 / atol 1e-4 (only the order of fp32 sums differs);
* bf16 out: within 1 bf16 ulp, plus 1e-6 absolute. bf16 inputs are
  multiples of 1/8 in [-2, 2], so every product and sum is exact in fp32 and
  only the epilogue's transcendentals differ between the two libraries; the
  1e-6 covers the tanh-form gelu of a large negative accumulator, which JAX's
  tanh rounds to exactly zero below x = -4.88 where PyTorch's gives ~-6e-7;
* ``requant_int8``: bitwise, on integer-valued inputs (ties included, so
  round-half-to-even is exercised).

The kernel itself runs only on the card: see ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jep
from repro.kernels.opope_gemm import opope_gemm as j_opope_gemm
from repro.kernels import ref as jref
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
from repro_torch.kernels import ops

SHAPES = [(5, 40, 24), (130, 300, 200), (128, 256, 128)]  # ragged and aligned
OPS = ["gelu", "silu", "swish", "relu", "bias", "residual", "mul", "scale",
       "requant_int8"]


def _grid(rng, shape):
    """Values on a 1/8 grid in [-2, 2]: exact in bf16, exact sums in fp32."""
    return rng.integers(-16, 17, shape).astype(np.float32) / 8.0


def _pair(x, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    if dtype == "bfloat16":
        j = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        t = torch.from_numpy(x).to(torch.bfloat16)
    else:
        j = jnp.asarray(x)
        t = torch.from_numpy(x)
    return j, t


def _np(x):
    """A JAX array or a tensor as a float32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or x.dtype.name == "bfloat16" else x


def _assert_bf16_within_ulp(got, want):
    got, want = _np(got), _np(want)
    _, e = np.frexp(want)
    ulp = np.ldexp(np.ones_like(want), e - 8)
    assert np.all(np.abs(got - want) <= ulp + 1e-6), np.max(np.abs(got - want))


def _assert_close(got, want, dtype):
    if dtype == "bfloat16":
        _assert_bf16_within_ulp(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_form", ["none", "row", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_matches_jax_kernel_and_oracle(shape, c_form, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n)
    a_j, a_t = _pair(_grid(rng, (m, k)), dtype)
    b_j, b_t = _pair(_grid(rng, (k, n)), dtype)
    c_j = c_t = None
    if c_form != "none":
        c_j, c_t = _pair(_grid(rng, (n,) if c_form == "row" else (m, n)), dtype)
    got = ops.matmul(a_t, b_t, c_t)
    assert got.dtype == a_t.dtype and tuple(got.shape) == (m, n)
    kern = j_opope_gemm(a_j, b_j, c_j, interpret=True)
    oracle = jref.reference_matmul(a_j, b_j, c_j)
    _assert_close(got, kern, dtype)
    _assert_close(got, oracle, dtype)


def _operand(rng, kind, m, n):
    if kind == "row":
        return _grid(rng, (n,))
    if kind == "full":
        return _grid(rng, (m, n))
    return None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", [o for o in OPS if o != "requant_int8"])
def test_each_epilogue_op_matches_jax_kernel(op, dtype):
    m, k, n = 37, 72, 48
    rng = np.random.default_rng(OPS.index(op))
    a_j, a_t = _pair(_grid(rng, (m, k)), dtype)
    b_j, b_t = _pair(_grid(rng, (k, n)), dtype)
    c_j, c_t = _pair(_grid(rng, (n,)), dtype)
    kind = tep.op_kind(op)
    assert kind == jep.op_kind(op)
    raw = _operand(rng, kind, m, n)
    if raw is None:
        spec_t, steps, canon = op, (op,), ()
    else:
        o_j, o_t = _pair(raw, dtype if kind == "full" else "float32")
        spec_t = (op, o_t)
        steps, canon = jep.normalize_epilogue((op, o_j))
        canon = jep.canonicalize_operands(steps, canon, n=n, m=m)
    got = ops.linear(a_t, b_t, c_t, epilogue=spec_t)
    want = j_opope_gemm(a_j, b_j, c_j, interpret=True, epilogue=steps,
                         epilogue_operands=canon)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("scale", [2.0, 4.0])
def test_requant_int8_is_bitwise(scale):
    m, k, n = 33, 20, 40
    rng = np.random.default_rng(int(scale))
    a = rng.integers(-3, 4, (m, k)).astype(np.float32)
    b = rng.integers(-3, 4, (k, n)).astype(np.float32)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     epilogue=[("requant_int8", scale)], out_dtype=torch.int8)
    steps, raw = jep.normalize_epilogue([("requant_int8", jnp.float32(scale))])
    canon = jep.canonicalize_operands(steps, raw, n=n, m=m)
    want = j_opope_gemm(jnp.asarray(a), jnp.asarray(b), interpret=True,
                         out_dtype=jnp.int8, epilogue=steps, epilogue_operands=canon)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ties at .5 exist with these scales: round half to even was exercised
    acc = a @ b
    assert np.any(np.abs(acc / scale - np.trunc(acc / scale)) == 0.5)


def test_silu_mul_chain_and_leading_dims_match_jax():
    """The SwiGLU gate lane as the model calls it: [B, S, K] input, a
    two-step chain with a full operand shaped like the output."""
    rng = np.random.default_rng(5)
    x = _grid(rng, (2, 6, 32))
    w = _grid(rng, (32, 24))
    up = _grid(rng, (2, 6, 24))
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                     epilogue=["silu", ("mul", torch.from_numpy(up))])
    steps, raw = jep.normalize_epilogue(["silu", ("mul", jnp.asarray(up))])
    canon = jep.canonicalize_operands(steps, raw, n=24, m=12)
    want = j_opope_gemm(jnp.asarray(x.reshape(12, 32)), jnp.asarray(w),
                         interpret=True, epilogue=steps, epilogue_operands=canon)
    assert tuple(got.shape) == (2, 6, 24)
    np.testing.assert_allclose(got.reshape(12, 24).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_cuda_backend_with_cpu_tensors_raises():
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    with pytest.raises(ValueError, match="cuda"):
        ops.matmul(a, b, backend="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.matmul(a, b, backend="pallas")
    assert ops.resolve_backend(None, torch.device("cpu")) == "torch"
    assert ops.resolve_backend("auto", torch.device("cuda")) == "cuda"


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    a = torch.randn(9, 17, generator=torch.Generator().manual_seed(0))
    b = torch.randn(17, 5, generator=torch.Generator().manual_seed(1))
    before = opope_gemm.launches
    got = opope_gemm(a, b, epilogue=("relu",))
    assert opope_gemm.launches == before
    torch.testing.assert_close(got, torch.relu(a @ b), rtol=1e-5, atol=1e-5)


def test_bad_specs_raise_like_the_reference():
    with pytest.raises(ValueError):
        tep.normalize_epilogue("gelux")
    with pytest.raises(ValueError):
        tep.normalize_epilogue(("relu", torch.ones(3)))
    with pytest.raises(ValueError):
        tep.normalize_epilogue("residual")
    with pytest.raises(ValueError):
        ops.matmul(torch.ones(2, 3), torch.ones(3, 4), epilogue=[("bias", torch.ones(5))])
    with pytest.raises(ValueError, match="requant_int8"):
        opope_gemm_plain(torch.ones(2, 3), torch.ones(3, 4), out_dtype=torch.int8)
    assert tep.epilogue_ops() == jep.epilogue_ops()
    assert tep.OP_CODES == {name: i for i, name in enumerate(OPS)}
