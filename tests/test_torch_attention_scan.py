"""The port's flash attention (K3) and linear scan (K6) against the JAX
reference, on the CPU.

The port's entry points (plain PyTorch versions: CPU tensors) and its
``ref`` oracles get the same numpy inputs as the JAX package's Pallas
kernels, run in interpret mode, and its oracles. Every case of
``tests/test_kernels_attention_scan.py`` is repeated here. Tolerances:

* attention, fp32: rtol = atol = 2e-4 against the interpret-mode kernel
  and the oracle, the reference's own tolerance. The two usually agree to
  6e-7, but in about one fresh pytest-xdist worker in ten the plain
  version's first fp32 result on this CPU came out 6.3e-5 from an fp64
  oracle (one softmax weight off by 6e-5 relative), which a tighter bound
  turns into a flaky failure;
* attention, bf16: 2e-2 absolute against the interpret-mode kernel (the
  reference allows 5e-2 against its oracle; both sides round P and the
  output to bf16, at places that differ by the running maximum);
* causal rows with no valid key (S > T) follow the interpret-mode kernel,
  whose value there depends on its block sizes, at the fp32 tolerance;
* the scan: bitwise. Both the interpret-mode kernel and the oracle round
  each step once (XLA contracts ``a * h + b`` into an FMA on the CPU); so
  do the port's plain version and oracle (``ref.fma_f32``).

The kernels themselves run only on the card: see ``tests/test_torch_gpu.py``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without the `test` extra
    from _hypothesis_fallback import given, settings, st

import repro.kernels as jkernels
from repro.kernels import ref as jref
from repro.kernels.opope_attention import opope_attention as j_attention
from repro.kernels.opope_attention import opope_attention_bhsd as j_attention_bhsd
from repro.kernels.opope_scan import opope_chunked_scan as j_scan
import repro_torch.kernels as tkernels
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels.opope_attention import (
    opope_attention,
    opope_attention_bhsd,
    opope_attention_plain,
)
from repro_torch.kernels.opope_scan import opope_chunked_scan, opope_chunked_scan_plain
from repro_torch.models.attention import blockwise_attention

FP32_TOL = 2e-4
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Keep this file's CPU share small beside the suite's wall-clock tests.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(x, dtype="float32"):
    """The same numpy values as a JAX array and a torch tensor."""
    if dtype == "bfloat16":
        return jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _qkv(rng, lead, s, t, d, dtype="float32"):
    return (_pair(rng.standard_normal(lead + (s, d)).astype(np.float32), dtype),
            _pair(rng.standard_normal(lead + (t, d)).astype(np.float32), dtype),
            _pair(rng.standard_normal(lead + (t, d)).astype(np.float32), dtype))


@pytest.mark.parametrize(
    "s,t,d,causal",
    [
        (128, 128, 64, True),
        (100, 160, 64, True),  # unaligned + cache-continuation offset
        (96, 128, 32, False),
        (77, 77, 64, True),
        (256, 256, 128, True),
    ],
)
def test_attention_matches_jax_kernel_and_oracle(s, t, d, causal):
    rng = np.random.default_rng(s + t + d)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (), s, t, d)
    want = j_attention(qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True)
    got = opope_attention(qt, kt, vt, causal=causal, block_q=64, block_k=64)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_TOL, atol=FP32_TOL)
    oracle = tref.reference_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(_np(oracle), _np(jref.reference_attention(qj, kj, vj, causal=causal)),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_attention_batched_bf16():
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (2, 3), 64, 64, 32, "bfloat16")
    want = j_attention_bhsd(qj, kj, vj, block_q=32, block_k=32, interpret=True)
    got = opope_attention_bhsd(qt, kt, vt, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 64, 32)
    assert np.max(np.abs(_np(got) - _np(want))) < BF16_TOL
    # Against the oracle, as the reference's own test holds its kernel.
    oracle = jax.vmap(jax.vmap(lambda q, k, v: jref.reference_attention(q, k, v)))(qj, kj, vj)
    assert np.max(np.abs(_np(got) - _np(oracle))) < 5e-2


@settings(max_examples=10, deadline=None)
@given(
    s=st.integers(16, 96),
    d=st.sampled_from([32, 64]),
    bq=st.sampled_from([16, 32, 64]),
    seed=st.integers(0, 2**31 - 1),
)
def test_attention_property(s, d, bq, seed):
    rng = np.random.default_rng(seed)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (), s, s, d)
    want = j_attention(qj, kj, vj, block_q=bq, block_k=bq, interpret=True)
    got = opope_attention(qt, kt, vt, block_q=bq, block_k=bq)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(_np(got), _np(tref.reference_attention(qt, kt, vt)),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("s,t,d", [(96, 64, 64), (200, 70, 32)])
@pytest.mark.parametrize("block", [32, 64])
def test_rows_without_a_valid_key_follow_the_jax_kernel(s, t, d, block):
    rng = np.random.default_rng(s * t + block)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (), s, t, d)
    want = j_attention(qj, kj, vj, block_q=block, block_k=block, interpret=True)
    got = opope_attention(qt, kt, vt, block_q=block, block_k=block)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_TOL, atol=FP32_TOL)
    # Only those rows depend on the blocks; the oracle leaves them NaN.
    other = opope_attention(qt, kt, vt, block_q=2 * block, block_k=2 * block)
    np.testing.assert_allclose(_np(other[s - t:]), _np(got[s - t:]), rtol=FP32_TOL,
                               atol=FP32_TOL)
    oracle = tref.reference_attention(qt, kt, vt)
    assert torch.isnan(oracle[: s - t]).all() and not torch.isnan(oracle[s - t:]).any()
    assert np.isnan(_np(jref.reference_attention(qj, kj, vj))[: s - t]).all()


def test_gqa_attention_matches_the_models_blockwise_attention():
    # Reduced chatglm3-6b: 4 query heads over 2 KV heads, head dim 16.
    cfg = get_config("chatglm3-6b").reduced()
    b, s, hq, hkv, d = 2, 96, cfg.n_heads, cfg.n_kv, cfg.head_dim_
    rng = np.random.default_rng(5)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(np.float32)).to(dtype)
        k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)).to(dtype)
        v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)).to(dtype)
        want = blockwise_attention(q, k, v, causal=True, q_chunk=32, kv_chunk=48)
        rep = hq // hkv
        got = opope_attention_bhsd(
            q.transpose(1, 2), k.repeat_interleave(rep, dim=2).transpose(1, 2),
            v.repeat_interleave(rep, dim=2).transpose(1, 2), causal=True)
        assert got.dtype == dtype
        assert np.max(np.abs(_np(got.transpose(1, 2)) - _np(want))) < tol


def test_attention_entry_points_reject_bad_shapes():
    q, k = torch.zeros(8, 16), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="2-D"):
        opope_attention(q[None], k, k)
    with pytest.raises(ValueError, match="shapes"):
        opope_attention(q, k, torch.zeros(8, 32))
    with pytest.raises(ValueError, match="4-D"):
        opope_attention_bhsd(q, k, k)
    with pytest.raises(ValueError, match="at least one key"):
        opope_attention(q, k[:0], k[:0])
    with pytest.raises(ValueError, match="block"):
        opope_attention_plain(q, k, k, block_q=0)


@pytest.mark.parametrize("s,d,chunk", [(128, 64, 32), (100, 32, 64), (64, 128, 64)])
def test_chunked_scan_matches_jax_bitwise(s, d, chunk):
    rng = np.random.default_rng(s + d)
    decay_j, decay_t = _pair(rng.uniform(0.2, 0.99, (s, d)).astype(np.float32))
    update_j, update_t = _pair(rng.standard_normal((s, d)).astype(np.float32))
    want = np.asarray(j_scan(decay_j, update_j, chunk=chunk, interpret=True))
    got = opope_chunked_scan(decay_t, update_t, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.reference_chunked_scan(decay_t, update_t).numpy(),
        np.asarray(jref.reference_chunked_scan(decay_j, update_j)))
    # The reference's own test: the kernel against its oracle.
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.reference_chunked_scan(
        decay_j, update_j)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_does_not_depend_on_the_chunk(dtype):
    rng = np.random.default_rng(7)
    s, d = 100, 3  # S no multiple of either chunk
    decay_j, decay_t = _pair(rng.uniform(0.2, 0.99, (s, d)).astype(np.float32), dtype)
    update_j, update_t = _pair(rng.standard_normal((s, d)).astype(np.float32), dtype)
    want = np.asarray(j_scan(decay_j, update_j, chunk=16, interpret=True))
    np.testing.assert_array_equal(np.asarray(j_scan(decay_j, update_j, chunk=64,
                                                    interpret=True)), want)
    for chunk in (1, 16, 64, 1000):
        np.testing.assert_array_equal(opope_chunked_scan(decay_t, update_t, chunk=chunk).numpy(),
                                      want)


def test_chunked_scan_rejects_bad_shapes():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match=r"\[S, D\]"):
        opope_chunked_scan(x, torch.zeros(4, 2))
    with pytest.raises(ValueError, match=r"\[S, D\]"):
        opope_chunked_scan_plain(x[None], x[None])
    with pytest.raises(ValueError, match="chunk"):
        opope_chunked_scan(x, x, chunk=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_form", ["none", "row", "full"])
def test_gemm_oracles_match_the_reference(dtype, c_form):
    rng = np.random.default_rng(len(c_form))
    g, m, k, n = 3, 5, 40, 24
    # Values on a 1/8 grid in [-2, 2]: exact in bf16, exact sums in fp32.
    a_j, a_t = _pair(rng.integers(-16, 17, (g, m, k)).astype(np.float32) / 8, dtype)
    b_j, b_t = _pair(rng.integers(-16, 17, (g, k, n)).astype(np.float32) / 8, dtype)
    c_shape = {"none": None, "row": (g, n), "full": (g, m, n)}[c_form]
    c_j = c_t = None
    if c_shape:
        c_j, c_t = _pair(rng.integers(-16, 17, c_shape).astype(np.float32) / 8, dtype)
    for out in (None, "float32"):
        j_out = None if out is None else jnp.float32
        t_out = None if out is None else torch.float32
        got = tref.reference_grouped_matmul(a_t, b_t, c_t, out_dtype=t_out)
        want = jref.reference_grouped_matmul(a_j, b_j, c_j, out_dtype=j_out)
        np.testing.assert_array_equal(_np(got), _np(want))
        c2_t = None if c_t is None else c_t[0]
        c2_j = None if c_j is None else c_j[0]
        got = tref.reference_matmul(a_t[0], b_t[0], c2_t, out_dtype=t_out)
        want = jref.reference_matmul(a_j[0], b_j[0], c2_j, out_dtype=j_out)
        np.testing.assert_array_equal(_np(got), _np(want))
        assert got.dtype == (t_out or a_t.dtype)


def test_scan_oracle_with_init_matches_the_reference():
    rng = np.random.default_rng(11)
    decay_j, decay_t = _pair(rng.uniform(0.2, 0.99, (33, 4, 5)).astype(np.float32))
    update_j, update_t = _pair(rng.standard_normal((33, 4, 5)).astype(np.float32))
    init_j, init_t = _pair(rng.standard_normal((5,)).astype(np.float32))
    np.testing.assert_array_equal(
        tref.reference_chunked_scan(decay_t, update_t, init_t).numpy(),
        np.asarray(jref.reference_chunked_scan(decay_j, update_j, init_j)))
    # A decay that broadcasts along the trailing axis.
    np.testing.assert_array_equal(
        tref.reference_chunked_scan(decay_t[:, :, :1], update_t).numpy(),
        np.asarray(jref.reference_chunked_scan(decay_j[:, :, :1], update_j)))


def test_fma_f32_rounds_once():
    # a * b + c lies just off an fp32 tie, within half an fp64 ulp of it:
    # rounding to fp64 and then to fp32 gives the wrong neighbour.
    a, b, c = (torch.tensor([float.fromhex(x)], dtype=torch.float32)
               for x in ("0x1.650e14p+0", "0x1.192c2p+0", "-0x1.328008p-32"))
    exact = Fraction(a.item()) * Fraction(b.item()) + Fraction(c.item())
    lo = np.float32(float(exact))
    nearest = min((lo, np.nextafter(lo, np.float32(-2)), np.nextafter(lo, np.float32(2))),
                  key=lambda x: abs(Fraction(float(x)) - exact))
    assert tref.fma_f32(a, b, c).item() == float(nearest) == float.fromhex("0x1.8829fep+0")
    assert (a.double() * b.double() + c.double()).float().item() != float(nearest)


def test_kernels_package_exports_the_references_names():
    assert tkernels.__all__ == jkernels.__all__
    for name in tkernels.__all__:
        assert hasattr(tkernels, name)
    assert tkernels.opope_attention is opope_attention
    assert tkernels.opope_chunked_scan is opope_chunked_scan
    assert tkernels.ref is tref and tkernels.ops.matmul
