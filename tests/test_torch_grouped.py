"""The port's grouped GEMM (K4) against the JAX reference, on the CPU.

The port's ``opope_gemm_grouped`` and ``grouped_matmul`` (plain PyTorch
version: CPU tensors) and the JAX package's Pallas kernel
``opope_gemm_grouped`` run in interpret mode, and its oracle
``reference_grouped_matmul``, get the same numpy inputs. Tolerances, as in
``test_torch_gemm.py``:

* fp32 out: rtol 1e-5 / atol 1e-4 (only the order of fp32 sums differs);
* bf16 out: within 1 bf16 ulp, plus 1e-6 absolute. Inputs are multiples of
  1/8 in [-2, 2], so every product and sum is exact in fp32 and only the
  epilogue's transcendentals differ between the two libraries;
* ``requant_int8``: bitwise, on integer-valued inputs.

The kernel itself runs only on the card: see ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as jep
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.opope_grouped import opope_gemm_grouped as j_grouped
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import ops
from repro_torch.kernels import opope_grouped as tk

G = 3
SHAPES = [(5, 40, 24), (130, 300, 200)]  # ragged: no dim a tile multiple


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grid(rng, shape):
    """Values on a 1/8 grid in [-2, 2]: exact in bf16, exact sums in fp32."""
    return rng.integers(-16, 17, shape).astype(np.float32) / 8.0


def _pair(x, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or x.dtype.name == "bfloat16" else x


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        _, e = np.frexp(want)
        ulp = np.ldexp(np.ones_like(want), e - 8)
        assert np.all(np.abs(got - want) <= ulp + 1e-6), np.max(np.abs(got - want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_form", ["none", "row", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grouped_matches_jax_kernel_and_oracle(shape, c_form, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + len(c_form))
    a_j, a_t = _pair(_grid(rng, (G, m, k)), dtype)
    b_j, b_t = _pair(_grid(rng, (G, k, n)), dtype)
    c_j = c_t = None
    if c_form != "none":
        c_j, c_t = _pair(_grid(rng, (G, n) if c_form == "row" else (G, m, n)), dtype)
    before = tk.opope_gemm_grouped.launches
    got = tk.opope_gemm_grouped(a_t, b_t, c_t)
    assert tk.opope_gemm_grouped.launches == before  # CPU: the plain version
    assert got.dtype == a_t.dtype and tuple(got.shape) == (G, m, n)
    _assert_close(got, j_grouped(a_j, b_j, c_j, interpret=True), dtype)
    _assert_close(got, jref.reference_grouped_matmul(a_j, b_j, c_j), dtype)
    # fp32 out from bf16 in, as the MoE down projection writes it.
    got32 = ops.grouped_matmul(a_t, b_t, c_t, out_dtype=torch.float32)
    _assert_close(got32, jref.reference_grouped_matmul(a_j, b_j, c_j, out_dtype=jnp.float32),
                  "float32")


def _operand(rng, kind, m, n, row_form):
    if kind == "row":
        return _grid(rng, (n,) if row_form == "[N]" else (G, n))
    if kind == "full":
        return _grid(rng, (G, m, n))
    return None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,row_form", [
    ("gelu", None), ("silu", None), ("swish", None), ("relu", None),
    ("bias", "[N]"), ("bias", "[G,N]"), ("scale", "[N]"), ("scale", "[G,N]"),
    ("residual", None), ("mul", None),
])
def test_each_epilogue_op_with_grouped_operands_matches_jax_kernel(op, row_form, dtype):
    m, k, n = 37, 72, 48
    rng = np.random.default_rng(len(op) + (row_form == "[N]"))
    a_j, a_t = _pair(_grid(rng, (G, m, k)), dtype)
    b_j, b_t = _pair(_grid(rng, (G, k, n)), dtype)
    c_j, c_t = _pair(_grid(rng, (G, n)), dtype)  # folded in as a leading bias
    kind = tep.op_kind(op)
    raw = _operand(rng, kind, m, n, row_form)
    if raw is None:
        spec_t, spec_j = op, op
    else:
        o_j, o_t = _pair(raw, dtype if kind == "full" else "float32")
        spec_t, spec_j = (op, o_t), (op, o_j)
    got = ops.grouped_matmul(a_t, b_t, c_t, epilogue=spec_t)
    steps, raw_j = jep.normalize_epilogue(spec_j)
    steps, raw_j = ("bias",) + steps, (c_j,) + raw_j
    canon = jep.canonicalize_operands(steps, raw_j, n=n, m=m, groups=G)
    want = j_grouped(a_j, b_j, interpret=True, epilogue=steps, epilogue_operands=canon)
    _assert_close(got, want, dtype)
    # The reference's registry entry folds C the same way.
    _assert_close(got, jops.grouped_matmul(a_j, b_j, c_j, backend="xla", epilogue=spec_j),
                  dtype)


def test_swiglu_gate_chain_and_fp32_down_match_jax():
    """The expert FFN's two epilogue lanes: silu + mul by a full [G, M, N]
    operand in bf16, and a plain GEMM written in fp32."""
    rng = np.random.default_rng(7)
    x_j, x_t = _pair(_grid(rng, (G, 9, 32)), "bfloat16")
    w_j, w_t = _pair(_grid(rng, (G, 32, 24)), "bfloat16")
    up_j, up_t = _pair(_grid(rng, (G, 9, 24)), "bfloat16")
    got = ops.grouped_matmul(x_t, w_t, epilogue=["silu", ("mul", up_t)])
    want = jops.grouped_matmul(x_j, w_j, backend="pallas_interpret",
                               epilogue=["silu", ("mul", up_j)])
    _assert_close(got, want, "bfloat16")
    d_j, d_t = _pair(_grid(rng, (G, 24, 32)), "bfloat16")
    got = ops.grouped_matmul(got, d_t, out_dtype=torch.float32)
    want = jops.grouped_matmul(want, d_j, backend="pallas_interpret", out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    _assert_close(got, want, "float32")


def test_requant_int8_grouped_is_bitwise():
    m, k, n, scale = 33, 20, 40, 2.0
    rng = np.random.default_rng(3)
    a = rng.integers(-3, 4, (G, m, k)).astype(np.float32)
    b = rng.integers(-3, 4, (G, k, n)).astype(np.float32)
    got = ops.grouped_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             epilogue=[("requant_int8", scale)], out_dtype=torch.int8)
    steps, raw = jep.normalize_epilogue([("requant_int8", jnp.float32(scale))])
    canon = jep.canonicalize_operands(steps, raw, n=n, m=m, groups=G)
    want = j_grouped(jnp.asarray(a), jnp.asarray(b), interpret=True, out_dtype=jnp.int8,
                     epilogue=steps, epilogue_operands=canon)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = np.einsum("gmk,gkn->gmn", a, b)
    assert np.any(np.abs(acc / scale - np.trunc(acc / scale)) == 0.5)


def test_canonical_grouped_operand_shapes():
    steps = ("requant_int8", "bias", "scale", "residual")
    raw = (torch.tensor(2.0), torch.ones(5), torch.ones(G, 5), torch.ones(G * 4, 5))
    got = tep.canonicalize_operands(steps, raw, n=5, m=4, groups=G)
    assert [tuple(x.shape) for x in got] == [(1, 1, 1), (G, 1, 5), (G, 1, 5), (G, 4, 5)]
    dense = tep.canonicalize_operands(steps, raw[:2] + (torch.ones(5), torch.ones(4, 5)),
                                      n=5, m=4)
    assert [tuple(x.shape) for x in dense] == [(1, 1), (1, 5), (1, 5), (4, 5)]
    with pytest.raises(ValueError):
        tep.canonicalize_operands(("bias",), (torch.ones(G + 1, 5),), n=5, m=4, groups=G)
    with pytest.raises(ValueError):
        tep.canonicalize_operands(("mul",), (torch.ones(G, 3, 5),), n=5, m=4, groups=G)


def test_cuda_backend_with_cpu_tensors_raises_and_grouped_calls_count_apart():
    a, b = torch.ones(G, 4, 8), torch.ones(G, 8, 16)
    with pytest.raises(ValueError, match="cuda"):
        ops.grouped_matmul(a, b, backend="cuda")
    ops.reset_counts()
    ops.grouped_matmul(a, b)
    ops.matmul(a[0], b[0])
    assert ops.backend("torch").grouped_calls == 1
    assert ops.backend("torch").calls == 1
    assert ops.backend("cuda").grouped_calls == 0


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(G, 9, 17, generator=gen), torch.randn(G, 17, 5, generator=gen)
    before = tk.opope_gemm_grouped.launches
    got = tk.opope_gemm_grouped(a, b, epilogue=("relu",))
    assert tk.opope_gemm_grouped.launches == before
    torch.testing.assert_close(got, torch.relu(torch.bmm(a, b)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("a_shape,b_shape,c_shape", [
    ((G, 4, 8), (G, 9, 16), None),  # K mismatch
    ((G, 4, 8), (G + 1, 8, 16), None),  # G mismatch
    ((4, 8), (8, 16), None),  # not grouped
    ((G, 4, 8), (G, 8, 16), (G, 3, 16)),  # bad full C
    ((G, 4, 8), (G, 8, 16), (16,)),  # a bare row is not a grouped C
])
def test_bad_shapes_raise_like_the_reference(a_shape, b_shape, c_shape):
    a, b = np.ones(a_shape, np.float32), np.ones(b_shape, np.float32)
    c = None if c_shape is None else np.ones(c_shape, np.float32)
    with pytest.raises(ValueError):
        jops.grouped_matmul(jnp.asarray(a), jnp.asarray(b),
                            None if c is None else jnp.asarray(c),
                            backend="pallas_interpret")
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           None if c is None else torch.from_numpy(c))
