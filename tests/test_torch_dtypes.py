"""The port's kernels take every dtype the reference's kernels take, on the CPU.

The dtype rule of ``repro_torch/kernels/opope_gemm.py`` (inputs, compute
type, out dtype, the final cast) held against the JAX package: K1 and K4
over every pair of fp32, bf16, fp16, e4m3 and e5m2 with C and a two-step
epilogue, K3 over fp32, bf16, fp16 and e4m3 at head dims 8 to 320, K6 over
fp16, e4m3 and e5m2. The port runs its plain versions here (the wrappers
take CPU tensors there); the reference runs its Pallas kernels in interpret
mode. Both get the same numpy inputs.

Integer-valued inputs make every fp32 sum exact whatever its order, so
those cases are bitwise (values equal, NaNs in the same places; e4m3 sums
past 448 are NaN on both sides). Random inputs: fp32 outputs within 2e-4
of an fp64 oracle, narrow outputs within one ulp of their dtype of the
reference's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.opope_attention import opope_attention_bhsd as j_attention_bhsd
from repro.kernels.opope_gemm import opope_gemm as j_gemm
from repro.kernels.opope_grouped import opope_gemm_grouped as j_grouped
from repro.kernels.opope_scan import opope_chunked_scan as j_scan
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.epilogue import cast_out
from repro_torch.kernels.opope_attention import opope_attention_bhsd
from repro_torch.kernels.opope_gemm import compute_dtype, opope_gemm, plan_dtype
from repro_torch.kernels.opope_grouped import opope_gemm_grouped
from repro_torch.kernels.opope_scan import opope_chunked_scan

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
NAMES = ["float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2"]
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn, "float8_e5m2": ml_dtypes.float8_e5m2}
# Mantissa bits (with the implicit one) and the exponent of the smallest
# normal, for one ulp of each output dtype.
ULP = {F32: (24, -126), BF16: (8, -126), F16: (11, -14), E4M3: (4, -6), E5M2: (3, -14)}
PAIRS = [(a, b) for a in NAMES for b in NAMES]


def _np(x, name):
    return np.asarray(x, np.float32).astype(NP_DTYPES[name])


def _both(x, name):
    """One numpy array as the reference's and the port's operand."""
    x = _np(x, name)
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(got, want):
    """Equal values in the same dtype, NaNs in the same places."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def _ulp(want, dtype):
    mant, emin = ULP[dtype]
    _, e = np.frexp(np.abs(want))
    return np.ldexp(1.0, np.maximum(e - 1, emin) - (mant - 1))


def _within_ulp(got, want, dtype, floor=False):
    """Within one ulp of ``dtype`` at each element's magnitude; with
    ``floor``, plus one at the output's largest magnitude (attention: P is
    rounded to v's dtype before P·V, and where that sum cancels the result
    keeps the terms' absolute error, not one of its own magnitude)."""
    g, w = _f32(got), _f32(want)
    assert (np.isnan(g) == np.isnan(w)).all()
    ok = ~np.isnan(w)
    tol = _ulp(w[ok], dtype)
    if floor:
        tol = tol + _ulp(np.abs(w[ok]).max(), dtype)
    assert (np.abs(g[ok] - w[ok]) <= tol).all()


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("a,b", [(a, b) for a in (F32, BF16, F16, E4M3, E5M2)
                                 for b in (F32, BF16, F16, E4M3, E5M2)],
                         ids=[f"{a}@{b}" for a, b in PAIRS])
def test_compute_type_is_the_narrowest_exact_of_fp16_bf16_fp32(a, b):
    pair = {a, b}
    if F32 in pair or pair == {F16, BF16}:
        want = F32
    elif BF16 in pair:
        want = BF16
    else:  # fp16 and the 8-bit floats: both 8-bit formats are exact in fp16
        want = F16
    assert compute_dtype(a, b) == want == compute_dtype(b, a)
    for dt in pair:  # every input is exact in the compute type
        x = torch.arange(-64, 65, dtype=F32).to(dt)
        assert torch.equal(x.to(want).float(), x.float())
    assert plan_dtype(a, b) == (a if a == b else None)


def test_compute_type_refuses_what_the_kernels_do_not_take():
    for dt in (torch.int8, torch.float64):
        with pytest.raises(TypeError):
            compute_dtype(dt, F32)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float16", "bfloat16"])
def test_final_cast_follows_the_reference_astype(name):
    """cast_out against jnp's astype on a sweep around each format's
    largest finite value and its tie with the next step (448 and 464 for
    e4m3, 57344 and 61440 for e5m2, 65504 and 65520 for fp16), around the
    subnormals, and at the infinities and NaN: e4m3 gives NaN past 464
    where torch's own cast saturates."""
    pts = np.array([448, 464, 57344, 61440, 65504, 65520, 2.0 ** -9, 2.0 ** -16, 1.0],
                   np.float32)
    steps = np.linspace(-1.0, 1.0, 41, dtype=np.float32)
    x = np.concatenate([(pts[:, None] * (1 + steps * 2.0 ** -3)).ravel(), pts + 1, pts - 1,
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e6, -1e6, 3.4e38]]).astype(np.float32)
    x = np.concatenate([x, -x])
    want = jnp.asarray(x).astype(jnp.dtype(name))
    got = cast_out(torch.from_numpy(x), getattr(torch, name))
    _same(got, want)
    if name == "float8_e4m3fn":
        assert np.isnan(_f32(got)[np.abs(x) > 464]).all()
        assert (_f32(got)[(np.abs(x) > 448) & (np.abs(x) <= 464)] != 0).all()


def test_tensor_from_numpy_carries_the_8bit_floats_bit_for_bit():
    x = np.arange(256, dtype=np.uint8)
    for name, dt in (("float8_e4m3fn", E4M3), ("float8_e5m2", E5M2)):
        t = tensor_from_numpy(x.view(NP_DTYPES[name]), "cpu")
        assert t.dtype == dt and torch.equal(t.view(torch.uint8), torch.from_numpy(x))


def _gemm_case(rng, lead, m, k, n, a_name, b_name, op_name, values):
    """Operands of one K1 (lead ()) or K4 (lead (G,)) call: A, B, a C in
    ``op_name``, and the row operand of ("relu", "scale"), in the
    reference's and the port's form."""
    draw = _ints if values == "ints" else (
        lambda r, s: r.standard_normal(s).astype(np.float32))
    a = draw(rng, lead + (m, k))
    b = draw(rng, lead + (k, n)) * (1.0 if values == "ints" else k ** -0.5)
    c = draw(rng, lead + (m, n))
    row = draw(rng, lead + (1, n) if lead else (n,))
    ja, ta = _both(a, a_name)
    jb, tb = _both(b, b_name)
    jc, tc = _both(c, op_name)
    jr, tr = _both(row, op_name)
    return (ja, jb, jc, jr), (ta, tb, tc, tr.reshape(lead + (1, n) if lead else (1, n)))


def _run_both(grouped, j_args, t_args, **kw):
    ja, jb, jc, jr = j_args
    ta, tb, tc, tr = t_args
    steps = ("relu", "scale")
    jfn = j_grouped if grouped else j_gemm
    tfn = opope_gemm_grouped if grouped else opope_gemm
    want = jfn(ja, jb, jc, interpret=True, epilogue=steps, epilogue_operands=(jr,), **kw)
    got = tfn(ta, tb, tc, epilogue=steps, epilogue_operands=(tr,), **kw)
    return got, want


@pytest.mark.parametrize("grouped", [False, True], ids=["k1", "k4"])
@pytest.mark.parametrize("a_name,b_name", PAIRS, ids=[f"{a}@{b}" for a, b in PAIRS])
def test_gemm_every_dtype_pair_matches_the_reference(a_name, b_name, grouped):
    """``epilogue(A @ B + C)`` with ("relu", "scale"), out in A's dtype by
    default: integer values bitwise, random ones within one ulp of the
    output dtype (fp32 out within 2e-4 of an fp64 oracle). C and the row
    operand take the 8-bit format of the pair, where there is one: the
    reference's kernels read both as fp32, whatever their dtype."""
    rng = np.random.default_rng(NAMES.index(a_name) * 5 + NAMES.index(b_name) + 25 * grouped)
    lead = (3,) if grouped else ()
    op_name = next((x for x in (a_name, b_name) if x.startswith("float8")), "float16")
    for values in ("ints", "random"):
        j_args, t_args = _gemm_case(rng, lead, 37, 96, 40, a_name, b_name, op_name, values)
        got, want = _run_both(grouped, j_args, t_args)
        assert got.dtype == getattr(torch, a_name)
        if values == "ints":
            _same(got, want)
            continue
        if got.dtype == F32:
            a, b, c, row = (x.double() for x in t_args)
            oracle = torch.relu(a @ b + c) * row
            torch.testing.assert_close(got.double(), oracle, rtol=2e-4, atol=2e-4)
        else:
            _within_ulp(got, want, got.dtype)


@pytest.mark.parametrize("grouped", [False, True], ids=["k1", "k4"])
def test_e4m3_output_overflows_to_nan_as_the_reference(grouped):
    """Sums of 448, 464, 468 and 512 written as e4m3: 448, 448, NaN, NaN
    on both sides (torch's own cast would give 448 for all four)."""
    a = np.zeros((4, 128), np.float32)
    for i, count in enumerate((112, 116, 117, 128)):
        a[i, :count] = 4.0
    b = np.ones((128, 16), np.float32)
    if grouped:
        a, b = a[None], b[None]
    ja, ta = _both(a, "float8_e4m3fn")
    jb, tb = _both(b, "float8_e4m3fn")
    got = (opope_gemm_grouped if grouped else opope_gemm)(ta, tb)
    want = (j_grouped if grouped else j_gemm)(ja, jb, interpret=True)
    _same(got, want)
    col = _f32(got).reshape(4, 16)[:, 0]
    assert col[0] == col[1] == 448.0 and np.isnan(col[2:]).all()


ATTN_NAMES = ["float32", "bfloat16", "float16", "float8_e4m3fn"]


# (S, T, block_q, block_k): one KV panel at the default blocks, and three
# of 32 keys (the last part padding) over two query blocks.
ATTN_PANELS = {"one_panel": (48, 64, 128, 128), "three_panels": (40, 90, 32, 32)}


def _attn_case(name, d, causal, panels):
    """q, k, v of one K3 case in the port's form, the reference's output,
    and the reference's blocks."""
    rng = np.random.default_rng(d + 7 * causal)
    s, t, bq, bk = ATTN_PANELS[panels]
    qkv = [rng.standard_normal((2, 2, n, d)).astype(np.float32) for n in (s, t, t)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, name) for x in qkv)
    want = j_attention_bhsd(jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    return (tq, tk, tv), want, dict(causal=causal, block_q=bq, block_k=bk)


def _attn_rms_spacings(got, want):
    """The error's RMS over the reference's RMS, in units of the output
    dtype's relative spacing."""
    g, w = _f32(got), _f32(want)
    spacing = 2.0 ** (1 - ULP[got.dtype][0])
    return np.sqrt(((g - w) ** 2).mean()) / np.sqrt((w ** 2).mean()) / spacing


# The narrow outputs' RMS gate, in spacings (see the test below it).
ATTN_RMS_SPACINGS = 1 / 16


@pytest.mark.parametrize("panels", list(ATTN_PANELS))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [8, 16, 80, 256, 320])
@pytest.mark.parametrize("name", ATTN_NAMES)
def test_attention_every_dtype_and_head_dim_matches_the_reference(name, d, causal, panels):
    """K3 in one dtype for q, k and v at any head dim, out in q's dtype:
    fp32 within 2e-4 of the reference, the narrow dtypes within one ulp of
    their own plus one at the output's largest magnitude, and an error RMS
    within ATTN_RMS_SPACINGS of their relative spacing times the
    reference's RMS. Over several KV panels P rounds to v's dtype at each
    panel's running maximum on both sides, so the same values round, up to
    the last bit of exp."""
    (tq, tk, tv), want, kw = _attn_case(name, d, causal, panels)
    got = opope_attention_bhsd(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(tq.shape)
    if name == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-4, atol=2e-4)
    else:
        _within_ulp(got, want, got.dtype, floor=True)
        assert _attn_rms_spacings(got, want) <= ATTN_RMS_SPACINGS


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [8, 80, 320])
@pytest.mark.parametrize("name", ["bfloat16", "float16", "float8_e4m3fn", "float8_e5m2"])
def test_attention_gate_rejects_p_rounded_elsewhere(name, d, causal):
    """Two controls over three KV panels, each beyond the RMS gate of the
    test above while the plain version meets it: P rounded to v's dtype at
    the final maximum (one panel over every key), and P not rounded at all (v widened to fp32, the
    output cast to q's dtype). Each passes the per-element gate, which so
    cannot tell them apart on its own."""
    (tq, tk, tv), want, kw = _attn_case(name, d, causal, "three_panels")
    got = opope_attention_bhsd(tq, tk, tv, **kw)
    assert _attn_rms_spacings(got, want) <= ATTN_RMS_SPACINGS
    final_max = opope_attention_bhsd(tq, tk, tv, **dict(kw, block_k=tk.shape[-2]))
    unrounded = cast_out(opope_attention_bhsd(tq.float(), tk.float(), tv.float(), **kw),
                         tq.dtype)
    for control in (final_max, unrounded):
        _within_ulp(control, want, control.dtype, floor=True)
        assert _attn_rms_spacings(control, want) > 2 * ATTN_RMS_SPACINGS


@pytest.mark.parametrize("decay_name,update_name",
                         [("float16", "float16"), ("float8_e4m3fn", "float8_e4m3fn"),
                          ("float8_e5m2", "float8_e5m2"), ("float32", "float8_e4m3fn"),
                          ("float16", "float8_e5m2")])
def test_scan_fp16_and_fp8_inputs_match_the_reference_bitwise(decay_name, update_name):
    rng = np.random.default_rng(3)
    decay = rng.uniform(0.2, 0.99, (70, 33)).astype(np.float32)
    update = rng.standard_normal((70, 33)).astype(np.float32)
    jd, td = _both(decay, decay_name)
    ju, tu = _both(update, update_name)
    want = j_scan(jd, ju, interpret=True)
    got = opope_chunked_scan(td, tu)
    assert got.dtype == F32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["dense", "grouped"])
def test_tuner_and_plan_keys_give_each_dtype_its_route(family):
    """A captured fp16 shape gets the sm90 plans bf16 gets (the table's
    width rule: 2-byte operands share them); an 8-bit shape gets none (its
    only route is tile), as fp32. ``ops``' plan hook keys a width the same
    way: 1 byte plans tile."""
    from repro_torch.kernels import ops
    from repro_torch.tune.search import candidate_blocks
    from repro_torch.tune.table import GemmShape

    g = 8 if family == "grouped" else 0
    plans = {name: candidate_blocks("cuda", GemmShape(family, 64, 512, 256, g, dtype=name))
             for name in NAMES}
    assert plans["float16"] == plans["bfloat16"] and plans["float16"]
    assert all(p.route == "sm90" for p in plans["float16"])
    for name in ("float32", "float8_e4m3fn", "float8_e5m2"):
        assert plans[name] == []
    for itemsize, route in ((1, "tile"), (2, "sm90"), (4, "tile")):
        assert ops._fp_tile(family, 64, 512, 256, itemsize=itemsize).route == route
