"""The port's CUDA kernels on the card (marked ``gpu``; skips without one).

Run on a machine with a GPU: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``. This file imports no JAX, so it runs where only
the port's dependencies are installed. Tolerances are those of
``chip_smoke.py``: fp32 out rtol 1e-4 / atol 1e-3 against the plain version;
bf16 out within one bf16 ulp of the plain fp32 result (plus 1e-5 of its
largest magnitude, for sum-order noise where it nearly cancels); int8 within
1 (a rounding boundary may fall between two sum orders). The int8 kernels
(K2, K5) sum exactly, so they are held bitwise against their plain versions
for every chain without a transcendental op, and within one ulp of the
output dtype (plus 1e-6 of the largest magnitude, where gelu cancels) with
one. The attention kernel (K3) is held to its plain version within
rtol = atol = 2e-4 (fp32), or (bf16) within 1e-2 + 1e-2·|plain| for each
element and an error RMS at most 2e-2 of the plain output's RMS, as in
``chip_smoke.py``; the scan (K6) bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import ops
from repro_torch.kernels.opope_attention import (
    opope_attention, opope_attention_bhsd, opope_attention_plain)
from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
from repro_torch.kernels import opope_grouped as tg
from repro_torch.kernels import opope_scan as tscan
from repro_torch.models import api
from repro_torch.quant import opope_q8 as tq8
from repro_torch.quant import PrecisionPolicy, mlp_q8_policy
from repro_torch.serve import ContinuousEngine, poisson_trace

pytestmark = pytest.mark.gpu

SHAPES = [(5, 40, 24), (130, 300, 200), (128, 256, 128), (4, 4096, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU form")
    return torch.device("cuda")


def _check(got, a, b, c, out_dtype, steps, operands, plain=opope_gemm_plain):
    if out_dtype == torch.int8:
        want = plain(a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=operands)
        assert (got.int() - want.int()).abs().max() <= 1
        return
    ref = plain(a, b, c, out_dtype=torch.float32, epilogue=steps, epilogue_operands=operands)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)
    else:
        _, e = torch.frexp(ref)
        tol = torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5 * ref.abs().max()
        assert ((got.float() - ref).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_for_every_op(cuda_device, shape, dtype):
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).to(dtype)
    row = torch.randn((1, n), generator=gen, device=cuda_device)
    full = torch.randn((m, n), generator=gen, device=cuda_device).to(dtype)
    for c in (None, torch.randn((n,), generator=gen, device=cuda_device).to(dtype), full):
        for op in tep.epilogue_ops():
            kind = tep.op_kind(op)
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": (torch.full((1, 1), 0.05, device=cuda_device),)}[kind]
            out_dtype = torch.int8 if op == "requant_int8" else dtype
            before = opope_gemm.launches
            got = opope_gemm(a, b, c, out_dtype=out_dtype, epilogue=(op,),
                             epilogue_operands=operands)
            torch.cuda.synchronize()
            assert opope_gemm.launches == before + 1
            _check(got, a, b, c, out_dtype, (op,), operands)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    a = torch.ones((4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        opope_gemm(a, a.t().contiguous())
    a = torch.ones((8, 4), device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        opope_gemm(a, torch.ones((8, 4), device=cuda_device))


# K1's sm90 route (TMA + wgmma): split-K shapes at decode and prefill
# widths, ragged M (1, 5, 63, 65, 130) against ragged N and a ragged K tail.
SM90_SHAPES = [(4, 4096, 4096), (512, 4096, 256), (1, 264, 136), (5, 40, 24), (63, 1032, 72),
               (65, 520, 200), (130, 136, 264), (64, 2048, 64)]


def _k1_module():
    import importlib
    return importlib.import_module("repro_torch.kernels.opope_gemm")


@pytest.mark.parametrize("shape", SM90_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sm90_route_matches_plain_for_every_op_and_out_dtype(cuda_device, shape):
    k1 = _k1_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert k1._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    row = torch.randn((1, n), generator=gen, device=cuda_device)
    full = torch.randn((m, n), generator=gen, device=cuda_device).bfloat16()
    acc_max = opope_gemm_plain(a, b, out_dtype=torch.float32).abs().max()
    for c in (None, torch.randn((n,), generator=gen, device=cuda_device).bfloat16(), full):
        for op in tep.epilogue_ops():
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": ((acc_max / 100.0).reshape(1, 1),)}[tep.op_kind(op)]
            for out_dtype in ((torch.int8,) if op == "requant_int8"
                              else (torch.bfloat16, torch.float16, torch.float32)):
                before = dict(opope_gemm.launches_by_route)
                got = opope_gemm(a, b, c, out_dtype=out_dtype, epilogue=(op,),
                                 epilogue_operands=operands)
                torch.cuda.synchronize()
                assert opope_gemm.launches_by_route == dict(before, sm90=before["sm90"] + 1)
                _check(got, a, b, c, out_dtype, (op,), operands)
    chain = ("silu", "mul", "requant_int8")
    operands = (full, (acc_max / 50.0).reshape(1, 1))
    got = opope_gemm(a, b, out_dtype=torch.int8, epilogue=chain, epilogue_operands=operands)
    _check(got, a, b, None, torch.int8, chain, operands)


@pytest.mark.parametrize("shape", [(4, 4096, 4096), (64, 2816, 2048), (512, 4096, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sm90_split_k_is_deterministic(cuda_device, shape):
    k1 = _k1_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda_device).bfloat16()
    assert k1._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).splits > 1
    res = torch.randn((m, n), generator=gen, device=cuda_device).bfloat16()
    outs = [opope_gemm(a, b, epilogue=("residual",), epilogue_operands=(res,),
                       out_dtype=torch.float32) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _check(outs[0], a, b, None, torch.float32, ("residual",), (res,))


def test_sm90_split_k_on_two_streams(cuda_device):
    """Each stream has its own split-K counters: calls in flight on two
    streams at once do not share them."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = [torch.randn((4, 4096), generator=gen, device=cuda_device).bfloat16() for _ in range(2)]
    b = [torch.randn((4096, 4096), generator=gen, device=cuda_device).bfloat16() for _ in range(2)]
    want = [opope_gemm(x, y) for x, y in zip(a, b)]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(opope_gemm(a[i], b[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


def test_k1_routes_and_their_counters(cuda_device):
    k1 = _k1_module()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((8, 64), generator=gen, device=cuda_device)
    b = torch.randn((64, 32), generator=gen, device=cuda_device)
    cases = [(a, b, "tile"),                                   # fp32 in
             (a.bfloat16(), b.bfloat16(), "sm90"),             # TMA-able bf16
             (a[:, :60].contiguous().bfloat16(), b[:60].bfloat16(), "tile"),  # 120-byte rows
             (a[:, :56].contiguous().bfloat16(), b[:56].bfloat16(), "sm90")]  # 112-byte rows
    for x, y, route in cases:
        before = dict(opope_gemm.launches_by_route)
        total = opope_gemm.launches
        got = opope_gemm(x, y)
        torch.cuda.synchronize()
        assert opope_gemm.launches == total + 1
        assert opope_gemm.launches_by_route == dict(before, **{route: before[route] + 1})
        _check(got, x, y, None, x.dtype, (), ())
    # A bf16 operand 8 bytes off a 16-byte boundary: the tile route.
    flat = torch.randn(8 * 64 + 4, generator=gen, device=cuda_device).bfloat16()
    x = flat[4:].view(8, 64)
    assert x.data_ptr() % 16 == 8
    before = dict(opope_gemm.launches_by_route)
    _check(opope_gemm(x, b.bfloat16()), x, b.bfloat16(), None, torch.bfloat16, (), ())
    assert opope_gemm.launches_by_route["tile"] == before["tile"] + 1
    # The same call forced onto each route; sm90 refuses what it cannot take.
    y = b.bfloat16()
    for route in ("sm90", "tile"):
        got = k1._run(a.bfloat16(), y, None, None, (), (), route=route)
        _check(got, a.bfloat16(), y, None, torch.bfloat16, (), ())
    with pytest.raises(ValueError, match="sm90"):
        k1._run(a, b, None, None, (), (), route="sm90")


GROUPED_SHAPES = [(3, 5, 40, 24), (3, 130, 300, 200), (64, 1, 2048, 1408), (64, 30, 1408, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grouped_kernel_matches_plain_for_every_op(cuda_device, shape, dtype):
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).to(dtype)
    b = (torch.randn((g, k, n), generator=gen, device=cuda_device) * k ** -0.5).to(dtype)
    row = torch.randn((g, 1, n), generator=gen, device=cuda_device)
    full = torch.randn((g, m, n), generator=gen, device=cuda_device).to(dtype)
    for c in (None, torch.randn((g, n), generator=gen, device=cuda_device).to(dtype), full):
        for op in tep.epilogue_ops():
            kind = tep.op_kind(op)
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": (torch.full((1, 1, 1), 0.05, device=cuda_device),)}[kind]
            for out_dtype in ((torch.int8,) if op == "requant_int8" else (dtype, torch.float32)):
                before = tg.opope_gemm_grouped.launches
                got = tg.opope_gemm_grouped(a, b, c, out_dtype=out_dtype, epilogue=(op,),
                                            epilogue_operands=operands)
                torch.cuda.synchronize()
                assert tg.opope_gemm_grouped.launches == before + 1
                _check(got, a, b, c, out_dtype, (op,), operands,
                       plain=tg.opope_gemm_grouped_plain)


def test_grouped_kernel_rejects_what_it_does_not_take(cuda_device):
    a = torch.ones((2, 4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tg.opope_gemm_grouped(a, a.transpose(1, 2).contiguous())
    a = torch.ones((2, 8, 4), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tg.opope_gemm_grouped(a, torch.ones((2, 8, 4), device=cuda_device))
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.ones((2, 4, 8)), torch.ones((2, 8, 4)), backend="cuda")


# K4's sm90 route (TMA + wgmma over rank-3 per-group maps): deepseek's
# expert shapes at decode and prefill capacity, ragged M (1, 5, 65) against
# N not a multiple of 128 and a K tail not a multiple of 64, M = 64 and 65
# on either side of the 128-row tile, G = 3 and 64.
GROUPED_SM90_SHAPES = [(3, 1, 200, 136), (3, 5, 40, 24), (3, 65, 200, 200),
                       (64, 1, 2048, 1408), (64, 30, 1408, 2048), (64, 60, 2048, 1408),
                       (64, 64, 200, 136), (64, 65, 264, 200)]


@pytest.mark.parametrize("shape", GROUPED_SM90_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grouped_sm90_route_matches_plain_for_every_op_and_out_dtype(cuda_device, shape):
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((g, k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert tg._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    row = torch.randn((g, 1, n), generator=gen, device=cuda_device)
    full = torch.randn((g, m, n), generator=gen, device=cuda_device).bfloat16()
    acc_max = tg.opope_gemm_grouped_plain(a, b, out_dtype=torch.float32).abs().max()
    crow = torch.randn((g, n), generator=gen, device=cuda_device).bfloat16()
    for c in (None, crow, full):
        for op in tep.epilogue_ops():
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": ((acc_max / 100.0).reshape(1, 1, 1),)}[tep.op_kind(op)]
            for out_dtype in ((torch.int8,) if op == "requant_int8"
                              else (torch.bfloat16, torch.float16, torch.float32)):
                before = dict(tg.opope_gemm_grouped.launches_by_route)
                got = tg.opope_gemm_grouped(a, b, c, out_dtype=out_dtype, epilogue=(op,),
                                            epilogue_operands=operands)
                torch.cuda.synchronize()
                assert tg.opope_gemm_grouped.launches_by_route == dict(
                    before, sm90=before["sm90"] + 1)
                _check(got, a, b, c, out_dtype, (op,), operands,
                       plain=tg.opope_gemm_grouped_plain)
    chain = ("silu", "mul", "requant_int8")
    operands = (full, (acc_max / 50.0).reshape(1, 1, 1))
    got = tg.opope_gemm_grouped(a, b, out_dtype=torch.int8, epilogue=chain,
                                epilogue_operands=operands)
    _check(got, a, b, None, torch.int8, chain, operands, plain=tg.opope_gemm_grouped_plain)


@pytest.mark.parametrize("shape", [(64, 1, 2048, 1408), (64, 60, 1408, 2048), (3, 65, 200, 136)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grouped_sm90_is_bitwise_on_repeat(cuda_device, shape):
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).bfloat16()
    b = torch.randn((g, k, n), generator=gen, device=cuda_device).bfloat16()
    gate = torch.randn((g, m, n), generator=gen, device=cuda_device).bfloat16()
    outs = [tg.opope_gemm_grouped(a, b, epilogue=("silu", "mul"), epilogue_operands=(gate,))
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _check(outs[0], a, b, None, torch.bfloat16, ("silu", "mul"), (gate,),
           plain=tg.opope_gemm_grouped_plain)


def test_k4_routes_and_their_counters(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((3, 8, 64), generator=gen, device=cuda_device)
    b = torch.randn((3, 64, 32), generator=gen, device=cuda_device)
    cases = [(a, b, "tile"),                                     # fp32 in
             (a.bfloat16(), b.bfloat16(), "sm90"),               # TMA-able bf16
             (a[:, :, :60].contiguous().bfloat16(), b[:, :60].contiguous().bfloat16(),
              "tile"),                                           # 120-byte rows of A
             (a[:, :, :56].contiguous().bfloat16(), b[:, :56].contiguous().bfloat16(),
              "sm90"),                                           # 112-byte rows
             (a.bfloat16(), b[:, :, :20].contiguous().bfloat16(), "tile")]  # 40-byte rows of B
    for x, y, route in cases:
        before = dict(tg.opope_gemm_grouped.launches_by_route)
        total = tg.opope_gemm_grouped.launches
        got = tg.opope_gemm_grouped(x, y)
        torch.cuda.synchronize()
        assert tg.opope_gemm_grouped.launches == total + 1
        assert tg.opope_gemm_grouped.launches_by_route == dict(
            before, **{route: before[route] + 1})
        _check(got, x, y, None, x.dtype, (), (), plain=tg.opope_gemm_grouped_plain)
    # A bf16 operand 8 bytes off a 16-byte boundary: the tile route.
    flat = torch.randn(3 * 8 * 64 + 4, generator=gen, device=cuda_device).bfloat16()
    x = flat[4:].view(3, 8, 64)
    assert x.data_ptr() % 16 == 8
    before = dict(tg.opope_gemm_grouped.launches_by_route)
    _check(tg.opope_gemm_grouped(x, b.bfloat16()), x, b.bfloat16(), None, torch.bfloat16, (),
           (), plain=tg.opope_gemm_grouped_plain)
    assert tg.opope_gemm_grouped.launches_by_route["tile"] == before["tile"] + 1
    # The same call forced onto each route; sm90 refuses what it cannot take.
    y = b.bfloat16()
    for route in ("sm90", "tile"):
        before = dict(tg.opope_gemm_grouped.launches_by_route)
        got = tg._run(a.bfloat16(), y, None, None, (), (), route=route)
        assert tg.opope_gemm_grouped.launches_by_route[route] == before[route] + 1
        _check(got, a.bfloat16(), y, None, torch.bfloat16, (), (),
               plain=tg.opope_gemm_grouped_plain)
    with pytest.raises(ValueError, match="sm90"):
        tg._run(a, b, None, None, (), (), route="sm90")


def _reduced_bf16(arch="chatglm3-6b"):
    return dataclasses.replace(get_config(arch).reduced(), param_dtype="bfloat16")


def test_reduced_model_prefill_on_the_kernel_matches_the_plain_backend(cuda_device):
    cfg = _reduced_bf16()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    tokens = tokens.to(cuda_device)
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 32, backend="torch")
        before = opope_gemm.launches
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 32)
    assert opope_gemm.launches - before == 7 * cfg.n_layers
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_continuous_engine_runs_every_gemm_on_the_kernel(cuda_device):
    cfg = _reduced_bf16()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    trace = poisson_trace(6, seed=1, vocab=cfg.vocab, prompt_lens=(5, 12, 20),
                          gen_lens=(3, 7), mean_interarrival=1.0)
    before = opope_gemm.launches
    report = ContinuousEngine(cfg=cfg, params=params, n_slots=2, max_len=32).serve(trace)
    launches = opope_gemm.launches - before
    assert launches == 7 * cfg.n_layers * (report.decode_steps + report.prefill_batches)
    assert all(len(report.outputs[r.rid]) == r.max_new_tokens for r in trace)


def test_reduced_deepseek_serves_every_expert_gemm_on_the_grouped_kernel(cuda_device):
    cfg = _reduced_bf16("deepseek-moe-16b")
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    trace = poisson_trace(6, seed=1, vocab=cfg.vocab, prompt_lens=(5, 12, 20),
                          gen_lens=(3, 7), mean_interarrival=1.0)
    k1, k4 = opope_gemm.launches, tg.opope_gemm_grouped.launches
    k4_routes = dict(tg.opope_gemm_grouped.launches_by_route)
    report = ContinuousEngine(cfg=cfg, params=params, n_slots=2, max_len=32).serve(trace)
    forwards = report.decode_steps + report.prefill_batches
    assert tg.opope_gemm_grouped.launches - k4 == 3 * cfg.n_layers * forwards
    # Every expert GEMM on the sm90 route.
    assert tg.opope_gemm_grouped.launches_by_route == dict(
        k4_routes, sm90=k4_routes["sm90"] + 3 * cfg.n_layers * forwards)
    assert opope_gemm.launches - k1 == 8 * cfg.n_layers * forwards
    assert all(len(report.outputs[r.rid]) == r.max_new_tokens for r in trace)


Q8_SHAPES = [(5, 40, 24), (130, 300, 200), (4, 4096, 256), (64, 1408, 2048)]
TRANSCENDENTAL = {"gelu", "silu", "swish"}


def _check_q8(got, want, op):
    if op not in TRANSCENDENTAL or got.dtype == torch.int8:
        assert torch.equal(got, want)
        return
    ref = want.float()
    _, e = torch.frexp(ref)
    mant = {torch.float32: 24, torch.bfloat16: 8, torch.float16: 11}[got.dtype]
    tol = torch.ldexp(torch.ones_like(ref), e - mant) + 1e-6 * ref.abs().max()
    assert ((got.float() - ref).abs() <= tol).all()


def _q8_operands(gen, dev, lead, k, n):
    a = torch.randint(-127, 128, lead + (k,), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, lead[:-1] + (k, n), generator=gen, device=dev, dtype=torch.int8)
    sa = torch.rand(lead + (1,), generator=gen, device=dev) * 1e-3
    sb = torch.rand(lead[:-1] + (1, n), generator=gen, device=dev) * 1e-2
    return a, sa, b, sb


@pytest.mark.parametrize("grouped", [False, True], ids=["k2", "k5"])
@pytest.mark.parametrize("shape", Q8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_kernels_match_plain_for_every_op(cuda_device, shape, grouped):
    m, k, n = shape
    g = 3 if grouped else 0
    lead = (g, m) if grouped else (m,)
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + g)
    a, sa, b, sb = _q8_operands(gen, cuda_device, lead, k, n)
    row = torch.randn(((g, 1, n) if grouped else (1, n)), generator=gen, device=cuda_device)
    full = torch.randn(lead + (n,), generator=gen, device=cuda_device).to(torch.bfloat16)
    crow = torch.randn(((g, n) if grouped else (n,)), generator=gen, device=cuda_device)
    kern, plain = ((tq8.opope_gemm_q8_grouped, tq8.opope_gemm_q8_grouped_plain) if grouped
                   else (tq8.opope_gemm_q8, tq8.opope_gemm_q8_plain))
    scalar = torch.full((1,) * (3 if grouped else 2), 0.05, device=cuda_device)
    for c in (None, crow, full):
        for op in tep.epilogue_ops():
            kind = tep.op_kind(op)
            operands = {"none": (), "row": (row,), "full": (full,), "scalar": (scalar,)}[kind]
            for out_dtype in ((torch.int8,) if op == "requant_int8" else
                              (torch.float32, torch.bfloat16)):
                before = kern.launches
                got = kern(a, sa, b, sb, c, out_dtype=out_dtype, epilogue=(op,),
                           epilogue_operands=operands)
                torch.cuda.synchronize()
                assert kern.launches == before + 1
                want = plain(a, sa, b, sb, c, out_dtype=out_dtype, epilogue=(op,),
                             epilogue_operands=operands)
                _check_q8(got, want, op)


def test_int8_accumulator_is_exact(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    a, _, b, _ = _q8_operands(gen, cuda_device, (64,), 1000, 192)
    ones_a, ones_b = torch.ones((64, 1), device=cuda_device), torch.ones((1, 192), device=cuda_device)
    got = tq8.opope_gemm_q8(a, ones_a, b, ones_b)
    exact = a.double() @ b.double()
    assert exact.abs().max() < 2 ** 24
    assert torch.equal(got.double(), exact)


def _q8_module():
    import importlib
    return importlib.import_module("repro_torch.quant.opope_q8")


def _k2_route(a, b):
    """The route K2's plan gives these operands."""
    return _q8_module()._plan(a.shape[0], b.shape[1], a.shape[1], a.data_ptr(),
                              b.data_ptr()).route


# K2's sm90 route at M of 1, 4 and 5 (the 8-row tile), 64 (one 128-row tile,
# half of it zero-filled) and 512 (four 128-row tiles), K and N off the
# 128-byte panel and tile.
Q8_SM90_SHAPES = [(1, 144, 272), (4, 4096, 256), (5, 400, 144), (64, 1040, 400),
                  (512, 272, 1040)]
Q8_REQUANT_CHAIN = ("bias", "scale", "residual", "mul", "relu", "requant_int8")


@pytest.mark.parametrize("shape", Q8_SM90_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_sm90_matches_plain_for_every_op(cuda_device, shape):
    """Every C kind and epilogue op, fp32/bf16/fp16 out, and a requant_int8
    chain, bitwise against the plain version (transcendental ops within one
    ulp), every launch on the sm90 route."""
    q8 = _q8_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (m,), k, n)
    assert _k2_route(a, b) == "sm90"
    row = torch.randn((1, n), generator=gen, device=cuda_device)
    full = torch.randn((m, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    crow = torch.randn((n,), generator=gen, device=cuda_device)
    scalar = torch.full((1, 1), 0.05, device=cuda_device)
    for c in (None, crow, full):
        for op in tep.epilogue_ops():
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": (scalar,)}[tep.op_kind(op)]
            for out_dtype in ((torch.int8,) if op == "requant_int8" else
                              (torch.float32, torch.bfloat16, torch.float16)):
                before = dict(q8.opope_gemm_q8.launches_by_route)
                got = q8.opope_gemm_q8(a, sa, b, sb, c, out_dtype=out_dtype, epilogue=(op,),
                                       epilogue_operands=operands)
                torch.cuda.synchronize()
                assert q8.opope_gemm_q8.launches_by_route == dict(before, sm90=before["sm90"] + 1)
                want = q8.opope_gemm_q8_plain(a, sa, b, sb, c, out_dtype=out_dtype,
                                              epilogue=(op,), epilogue_operands=operands)
                _check_q8(got, want, op)
    operands = (crow.reshape(1, n), row, full, full, scalar)
    got = q8.opope_gemm_q8(a, sa, b, sb, full, out_dtype=torch.int8, epilogue=Q8_REQUANT_CHAIN,
                           epilogue_operands=operands)
    want = q8.opope_gemm_q8_plain(a, sa, b, sb, full, out_dtype=torch.int8,
                                  epilogue=Q8_REQUANT_CHAIN, epilogue_operands=operands)
    assert torch.equal(got, want)
    # The int32 sum is exact: with unit scales the fp32 output is the integer
    # product wherever |acc| < 2^24.
    ones_a, ones_b = torch.ones_like(sa), torch.ones_like(sb)
    exact = a.double() @ b.double()
    assert exact.abs().max() < 2 ** 24
    assert torch.equal(q8.opope_gemm_q8(a, ones_a, b, ones_b).double(), exact)


@pytest.mark.parametrize("shape", [(4, 4096, 1024), (4, 13696, 4096), (256, 2048, 2816)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_sm90_split_k_is_bitwise_on_repeat(cuda_device, shape):
    q8 = _q8_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (m,), k, n)
    plan = q8._plan(m, n, k, a.data_ptr(), b.data_ptr())
    assert plan.route == "sm90" and plan.splits > 1
    res = torch.randn((m, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    outs = [q8.opope_gemm_q8(a, sa, b, sb, out_dtype=torch.bfloat16, epilogue=("residual",),
                             epilogue_operands=(res,)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    want = q8.opope_gemm_q8_plain(a, sa, b, sb, out_dtype=torch.bfloat16,
                                  epilogue=("residual",), epilogue_operands=(res,))
    assert torch.equal(outs[0], want)


def test_k2_split_k_shares_counters_with_k1(cuda_device):
    """K1 and K2 split K on one stream's counters, one call after another."""
    q8 = _q8_module()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (4,), 4096, 1024)
    x = torch.randn((4, 4096), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((4096, 4096), generator=gen, device=cuda_device).bfloat16()
    want_q8 = q8.opope_gemm_q8_plain(a, sa, b, sb)
    want_k1 = opope_gemm(x, w)
    for _ in range(4):
        got_q8, got_k1 = q8.opope_gemm_q8(a, sa, b, sb), opope_gemm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got_q8, want_q8) and torch.equal(got_k1, want_k1)


def test_k2_routes_and_their_counters(cuda_device):
    """Ragged K or N and a misaligned base take the tile route; each call
    counts on its route; both routes forced through _launch agree bit for
    bit; sm90 refuses, launching nothing, what its plan does not take."""
    q8 = _q8_module()
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (8,), 4104, 264)
    flat = torch.randint(-127, 128, (8 * 256 + 8,), generator=gen, device=cuda_device,
                         dtype=torch.int8)
    off = flat[8:].view(8, 256)  # a base 8 bytes off a 16-byte boundary
    assert off.data_ptr() % 16 == 8
    cases = [((a, sa, b, sb), "tile"),                                   # K, N off 16
             ((a[:, :4096].contiguous(), sa, b[:4096, :256].contiguous(), sb[:, :256]),
              "sm90"),
             ((a[:, :40].contiguous(), sa, b[:40, :24].contiguous(), sb[:, :24]), "tile"),
             ((off, sa, b[:256, :256].contiguous(), sb[:, :256]), "tile")]
    for (x, xs, w, ws), route in cases:
        ws = ws.contiguous()
        assert _k2_route(x, w) == route
        before = (q8.opope_gemm_q8.launches, dict(q8.opope_gemm_q8.launches_by_route))
        got = q8.opope_gemm_q8(x, xs, w, ws, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert q8.opope_gemm_q8.launches == before[0] + 1
        assert q8.opope_gemm_q8.launches_by_route == dict(before[1],
                                                          **{route: before[1][route] + 1})
        want = q8.opope_gemm_q8_plain(x, xs, w, ws, out_dtype=torch.bfloat16)
        assert torch.equal(got, want)
        forced = {r: q8._launch(x, xs, w, ws, out_dtype=torch.bfloat16, route=r)
                  for r in (("sm90", "tile") if route == "sm90" else ("tile",))}
        assert all(torch.equal(v, want) for v in forced.values())
        if route == "tile":
            before = (q8.opope_gemm_q8.launches, dict(q8.opope_gemm_q8.launches_by_route))
            with pytest.raises(ValueError, match="sm90"):
                q8._launch(x, xs, w, ws, route="sm90")
            assert (q8.opope_gemm_q8.launches, q8.opope_gemm_q8.launches_by_route) == before


def _k5_route(a, b):
    """The route K5's plan gives these operands."""
    return _q8_module()._plan_grouped(a.shape[0], a.shape[1], b.shape[2], a.shape[2],
                                      a.data_ptr(), b.data_ptr()).route


# K5's sm90 route at G = 3 and 64: M of 1, 5 and 8 (the 8-row tile), 9, 64,
# 65 and 130 (the 128-row tile, one or two of them), K tails of 144 and 1040
# (a partial 128-byte panel), N of 144 and 208 (a partial 128-column tile),
# and deepseek-moe-16b's w_up at decode.
K5_SM90_SHAPES = [(3, 1, 144, 272), (3, 5, 1040, 208), (3, 8, 400, 144), (3, 9, 144, 208),
                  (3, 65, 272, 144), (3, 130, 1040, 208), (64, 1, 2048, 1408),
                  (64, 64, 1040, 208)]


@pytest.mark.parametrize("shape", K5_SM90_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k5_sm90_matches_plain_for_every_op(cuda_device, shape):
    """Every C form and epilogue op, fp32/bf16/fp16 out, and a requant_int8
    chain, bitwise against the plain version (transcendental ops within one
    ulp), every launch on the sm90 route; with unit scales the integer
    product exactly."""
    q8 = _q8_module()
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (g, m), k, n)
    assert _k5_route(a, b) == "sm90"
    row = torch.randn((g, 1, n), generator=gen, device=cuda_device)
    full = torch.randn((g, m, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    crow = torch.randn((g, n), generator=gen, device=cuda_device)
    scalar = torch.full((1, 1, 1), 0.05, device=cuda_device)
    kern = q8.opope_gemm_q8_grouped
    for c in (None, crow, full):
        for op in tep.epilogue_ops():
            operands = {"none": (), "row": (row,), "full": (full,),
                        "scalar": (scalar,)}[tep.op_kind(op)]
            for out_dtype in ((torch.int8,) if op == "requant_int8" else
                              (torch.float32, torch.bfloat16, torch.float16)):
                before = dict(kern.launches_by_route)
                got = kern(a, sa, b, sb, c, out_dtype=out_dtype, epilogue=(op,),
                           epilogue_operands=operands)
                torch.cuda.synchronize()
                assert kern.launches_by_route == dict(before, sm90=before["sm90"] + 1)
                want = q8.opope_gemm_q8_grouped_plain(a, sa, b, sb, c, out_dtype=out_dtype,
                                                      epilogue=(op,), epilogue_operands=operands)
                _check_q8(got, want, op)
    operands = (crow.reshape(g, 1, n), row, full, full, scalar)
    got = kern(a, sa, b, sb, full, out_dtype=torch.int8, epilogue=Q8_REQUANT_CHAIN,
               epilogue_operands=operands)
    want = q8.opope_gemm_q8_grouped_plain(a, sa, b, sb, full, out_dtype=torch.int8,
                                          epilogue=Q8_REQUANT_CHAIN, epilogue_operands=operands)
    assert torch.equal(got, want)
    ones_a, ones_b = torch.ones_like(sa), torch.ones_like(sb)
    exact = torch.matmul(a.double(), b.double())
    assert exact.abs().max() < 2 ** 24
    assert torch.equal(kern(a, ones_a, b, ones_b).double(), exact)


@pytest.mark.parametrize("shape", [(64, 1, 2048, 1408), (64, 60, 1408, 2048), (3, 9, 1040, 208)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k5_sm90_is_bitwise_on_repeat_and_against_the_tile_route(cuda_device, shape):
    """A repeat gives the same bits, the plain version's, and so does the
    tile route."""
    q8 = _q8_module()
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (g, m), k, n)
    gate = torch.randn((g, m, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    kw = dict(out_dtype=torch.bfloat16, epilogue=("residual",), epilogue_operands=(gate,))
    outs = [q8.opope_gemm_q8_grouped(a, sa, b, sb, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    want = q8.opope_gemm_q8_grouped_plain(a, sa, b, sb, **kw)
    assert torch.equal(outs[0], want)
    assert torch.equal(q8._launch_grouped(a, sa, b, sb, route="tile", **kw), want)


def test_k5_zero_capacity_experts_give_exact_zeros(cuda_device):
    """At decode, experts that no token reached hold zero rows (quantized to
    q = 0 with a floor scale): their outputs are exactly zero, on sm90."""
    from repro_torch.quant import backends as qb

    q8 = _q8_module()
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.randn((64, 1, 2048), generator=gen, device=cuda_device).to(torch.bfloat16)
    x[::2] = 0
    w = (torch.randn((64, 2048, 1408), generator=gen, device=cuda_device) * 2048 ** -0.5)
    xq, wq = qb.quantize_grouped_operands(x, w.to(torch.bfloat16))
    assert _k5_route(xq.q, wq.q) == "sm90"
    before = dict(q8.opope_gemm_q8_grouped.launches_by_route)
    for od in (torch.float32, torch.bfloat16):
        out = q8.opope_gemm_q8_grouped(xq.q, xq.scale, wq.q, wq.scale, out_dtype=od)
        torch.cuda.synchronize()
        assert not out[::2].any() and out[1::2].any()
        assert torch.equal(out, q8.opope_gemm_q8_grouped_plain(xq.q, xq.scale, wq.q, wq.scale,
                                                               out_dtype=od))
    assert q8.opope_gemm_q8_grouped.launches_by_route == dict(before, sm90=before["sm90"] + 2)


def test_k5_routes_and_their_counters(cuda_device):
    """Ragged K or N and a misaligned base take the tile route; each call
    counts on its route; both routes forced agree bit for bit; sm90 refuses,
    launching nothing, what its plan does not take; more groups than the
    grid holds raise on both routes before any launch."""
    q8 = _q8_module()
    kern = q8.opope_gemm_q8_grouped
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (3, 8), 1000, 264)
    flat = torch.randint(-127, 128, (3 * 8 * 256 + 8,), generator=gen, device=cuda_device,
                         dtype=torch.int8)
    off = flat[8:].view(3, 8, 256)  # a base 8 bytes off a 16-byte boundary
    assert off.data_ptr() % 16 == 8
    cases = [((a, sa, b, sb), "tile"),                                    # K off 16
             ((a[..., :992].contiguous(), sa, b[:, :992, :256].contiguous(), sb[..., :256]),
              "sm90"),
             ((a[..., :40].contiguous(), sa, b[:, :40, :24].contiguous(), sb[..., :24]), "tile"),
             ((off, sa, b[:, :256, :256].contiguous(), sb[..., :256]), "tile")]
    for (x, xs, w, ws), route in cases:
        ws = ws.contiguous()
        assert _k5_route(x, w) == route
        before = (kern.launches, dict(kern.launches_by_route))
        got = kern(x, xs, w, ws, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert kern.launches == before[0] + 1
        assert kern.launches_by_route == dict(before[1], **{route: before[1][route] + 1})
        want = q8.opope_gemm_q8_grouped_plain(x, xs, w, ws, out_dtype=torch.bfloat16)
        assert torch.equal(got, want)
        forced = {r: q8._launch_grouped(x, xs, w, ws, out_dtype=torch.bfloat16, route=r)
                  for r in (("sm90", "tile") if route == "sm90" else ("tile",))}
        assert all(torch.equal(v, want) for v in forced.values())
        if route == "tile":
            before = (kern.launches, dict(kern.launches_by_route))
            with pytest.raises(ValueError, match="sm90"):
                q8._launch_grouped(x, xs, w, ws, route="sm90")
            assert (kern.launches, kern.launches_by_route) == before
    g = q8._MAX_GROUPS + 1
    x = torch.zeros((g, 1, 16), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((g, 16, 16), dtype=torch.int8, device=cuda_device)
    xs, ws = torch.ones((g, 1, 1), device=cuda_device), torch.ones((g, 1, 16), device=cuda_device)
    before = (kern.launches, dict(kern.launches_by_route))
    for route in (None, "sm90", "tile"):
        with pytest.raises(ValueError, match="groups"):
            q8._launch_grouped(x, xs, w, ws, route=route)
    assert (kern.launches, kern.launches_by_route) == before


def test_reduced_deepseek_q8_runs_every_k5_launch_on_sm90(cuda_device):
    """A reduced deepseek-moe-16b prefill and decode step under
    ``{"moe": "q8"}``: every K5 launch on the sm90 route, the logits within
    the q8 model test's bound of the plain backends'."""
    cfg = _reduced_bf16("deepseek-moe-16b")
    policy = PrecisionPolicy(rules={"moe": "q8"})
    plain_policy = PrecisionPolicy(rules={"moe": "torch_q8"}, default="torch")
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    tokens = tokens.to(cuda_device)
    kern = tq8.opope_gemm_q8_grouped
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 24, backend=plain_policy)
        before = (kern.launches, dict(kern.launches_by_route))
        got, caches = api.prefill(cfg, params, {"tokens": tokens}, 24, backend=policy)
        logits, _ = api.decode(cfg, params, got.argmax(-1)[:, None], caches, 16, backend=policy)
        torch.cuda.synchronize()
    launches = kern.launches - before[0]
    assert launches == 3 * cfg.n_layers * 2
    assert kern.launches_by_route == dict(before[1], sm90=before[1]["sm90"] + launches)
    assert torch.isfinite(got).all() and torch.isfinite(logits).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.parametrize("arch,policy,counts", [
    ("chatglm3-6b", mlp_q8_policy(), {"k1": 4, "k2": 3, "k5": 0}),
    ("deepseek-moe-16b", PrecisionPolicy(rules={"moe": "q8"}), {"k1": 5, "k2": 3, "k5": 3}),
], ids=["chatglm3-6b", "deepseek-moe-16b"])
def test_reduced_models_under_the_q8_policy_run_on_the_kernels(cuda_device, arch, policy, counts):
    cfg = _reduced_bf16(arch)
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    tokens = tokens.to(cuda_device)
    plain_policy = dataclasses.replace(
        policy, rules={r: "torch_q8" for r in policy.rules}, default="torch")
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 32, backend=plain_policy)
        before = {"k1": opope_gemm.launches, "k2": tq8.opope_gemm_q8.launches,
                  "k5": tq8.opope_gemm_q8_grouped.launches}
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 32, backend=policy)
    after = {"k1": opope_gemm.launches, "k2": tq8.opope_gemm_q8.launches,
             "k5": tq8.opope_gemm_q8_grouped.launches}
    assert {k: after[k] - before[k] for k in after} == {
        k: v * cfg.n_layers for k, v in counts.items()}
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


# K3: (B, H, S, T, D, causal) — the reference's test shapes, its batched
# case, S > T with rows that have no valid key, and a decode row.
ATTN_SHAPES = [(1, 1, 128, 128, 64, True), (1, 1, 100, 160, 64, True),
               (1, 1, 96, 128, 32, False), (1, 1, 77, 77, 64, True),
               (1, 1, 256, 256, 128, True), (2, 3, 64, 64, 32, True),
               (2, 4, 96, 64, 16, True), (2, 2, 200, 70, 32, True), (1, 4, 1, 300, 128, True)]


def _attn_close(got, want):
    """K3 against its plain version: fp32 within rtol = atol = 2e-4 (the
    reference's own tolerance). bf16 (P and the output round to bf16 at
    places that differ by the running maximum) within 1e-2 + 1e-2·|plain|
    for each element, and with an error RMS at most 2e-2 of the plain
    output's RMS, so that a wrong panel cannot hide in the many small
    outputs of a long key range."""
    assert torch.isfinite(got.float()).all()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        assert (got - want).square().mean().sqrt() <= 2e-2 * want.square().mean().sqrt()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(cuda_device, shape, dtype):
    b, h, s, t, d, causal = shape
    gen = torch.Generator(device=cuda_device).manual_seed(b * h + s + t + d)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda_device).to(dtype)
               for n in (s, t, t))
    for block in ((32, 64) if causal and s > t else (128,)):
        before = opope_attention.launches
        got = opope_attention_bhsd(q, k, v, causal=causal, block_q=block, block_k=block)
        torch.cuda.synchronize()
        assert opope_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        _attn_close(got, opope_attention_plain(q, k, v, causal=causal, block_q=block,
                                               block_k=block))
    single = opope_attention(q[0, 0], k[0, 0], v[0, 0], causal=causal)
    _attn_close(single, opope_attention_plain(q[0, 0], k[0, 0], v[0, 0], causal=causal))


def test_attention_kernel_reads_strided_views_in_place(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 80, 3, 3, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, D] views of [B, S, H, D]
    got = opope_attention_bhsd(q, k, v)
    want = opope_attention_bhsd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.ones((1, 1, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        opope_attention_bhsd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="dtype"):
        opope_attention_bhsd(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.ones((1, 1, 8, 48), device=cuda_device)
        opope_attention_bhsd(y, y, y)
    with pytest.raises(ValueError, match="cuda"):
        opope_attention_bhsd(x, x.cpu(), x)


def _k3_module():
    import importlib
    return importlib.import_module("repro_torch.kernels.opope_attention")


def _k3_route(q, k, v, causal):
    """The route K3's plan gives these operands."""
    return _k3_module()._plan(q.shape, k.shape[2], q.dtype, causal,
                              (q.stride(), k.stride(), v.stride()),
                              (q.data_ptr(), k.data_ptr(), v.data_ptr())).route


def _qkv(device, shape, dtype, seed):
    b, h, s, t, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, h, n, d), generator=gen, device=device).to(dtype)
                 for n in (s, t, t))


@pytest.mark.parametrize("route", ["sm90", "tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_routes_match_plain(cuda_device, shape, dtype, route):
    """ATTN_SHAPES forced onto each route, at _attn_close's gates; the sm90
    route refuses, launching nothing, what its plan does not give it."""
    k3 = _k3_module()
    b, h, s, t, d, causal = shape
    q, k, v = _qkv(cuda_device, (b, h, s, t, d), dtype, b * h + s + t + d)
    before = dict(k3.opope_attention.launches_by_route)
    if route == "sm90" and _k3_route(q, k, v, causal) != "sm90":
        with pytest.raises(ValueError, match="sm90"):
            k3._launch(q, k, v, causal, 128, 128, route="sm90")
        assert k3.opope_attention.launches_by_route == before
        return
    got = k3._launch(q, k, v, causal, 128, 128, route=route)
    torch.cuda.synchronize()
    assert k3.opope_attention.launches_by_route == dict(before, **{route: before[route] + 1})
    _attn_close(got, opope_attention_plain(q, k, v, causal=causal))


# The sm90 route's panel edges: S and T of 1, 127, 128, 129 and 300 (rows
# and keys short of, at and past a 128 tile or panel), continuations whose
# causal diagonal crosses a panel, head dims 64 and 128, B·H > 1.
SM90_ATTN_CASES = sorted(
    {(1, 1, s, t, 128, causal) for s in (1, 127, 128, 129, 300) for t in (1, 127, 128, 129, 300)
     for causal in (True, False) if not (causal and s > t)}
    | {(1, 2, 100, 160, 64, True), (2, 3, 200, 328, 128, True), (1, 1, 129, 1000, 128, True),
       (2, 2, 300, 300, 64, False), (1, 1, 1, 1, 64, True), (3, 5, 257, 700, 64, True)})


@pytest.mark.parametrize("shape", SM90_ATTN_CASES, ids=lambda s: "x".join(map(str, s)))
def test_attention_sm90_panel_edges_match_plain(cuda_device, shape):
    k3 = _k3_module()
    b, h, s, t, d, causal = shape
    q, k, v = _qkv(cuda_device, (b, h, s, t, d), torch.bfloat16, 7 * s + t + d + b * h)
    assert _k3_route(q, k, v, causal) == "sm90"
    before = dict(k3.opope_attention.launches_by_route)
    got = opope_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert k3.opope_attention.launches_by_route == dict(before, sm90=before["sm90"] + 1)
    _attn_close(got, opope_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("d", [64, 128])
def test_attention_sm90_is_bitwise_on_repeat_and_for_strided_views(cuda_device, d):
    """The [B, H, S, D] views of [B, S, H, D] tensors are read in place by
    rank-4 tensor maps: the result equals the contiguous inputs' bit for
    bit, and a repeat equals the first call."""
    k3 = _k3_module()
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((2, 300, 3, 4, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, D] views
    for causal in (True, False):
        assert _k3_route(q, k, v, causal) == "sm90"
        got = opope_attention_bhsd(q, k, v, causal=causal)
        again = opope_attention_bhsd(q, k, v, causal=causal)
        want = opope_attention_bhsd(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
        assert torch.equal(got, again) and torch.equal(got, want)
        _attn_close(got, opope_attention_plain(q, k, v, causal=causal))


def test_k3_routes_and_their_counters(cuda_device):
    """launches_by_route counts the route the plan chose, call by call."""
    k3 = _k3_module()
    q, k, v = _qkv(cuda_device, (1, 2, 64, 96, 64), torch.bfloat16, 11)
    wide = torch.randn((1, 1, 96, 64), device=cuda_device).to(torch.bfloat16).expand(1, 2, 96, 64)
    cases = [((q, k, v, True), "sm90"),
             ((q.float(), k.float(), v.float(), True), "tile"),   # fp32
             ((q[..., :32], k[..., :32], v[..., :32], True), "tile"),  # head dim 32, strided
             ((k, q, q, True), "tile"),                           # causal S > T
             ((q, wide, wide, False), "tile"),                    # a head stride of 0
             ((q, k, v, False), "sm90")]
    for (qq, kk, vv, causal), route in cases:
        assert _k3_route(qq, kk, vv, causal) == route
        before = dict(k3.opope_attention.launches_by_route)
        got = opope_attention_bhsd(qq, kk, vv, causal=causal)
        torch.cuda.synchronize()
        assert k3.opope_attention.launches_by_route == dict(before, **{route: before[route] + 1})
        _attn_close(got, opope_attention_plain(qq, kk, vv, causal=causal))


def test_attention_raises_on_what_neither_route_takes(cuda_device):
    """Refused before any launch, on both routes, with no fallback."""
    k3 = _k3_module()
    x = torch.ones((1, 1, 8, 64), device=cuda_device)
    before = (k3.opope_attention.launches, dict(k3.opope_attention.launches_by_route))
    for route in (None, "sm90", "tile"):
        with pytest.raises(ValueError, match="dtype"):
            k3._launch(x.half(), x.half(), x.half(), True, 128, 128, route=route)
        with pytest.raises(ValueError, match="head dims"):
            y = torch.ones((1, 1, 8, 48), device=cuda_device, dtype=torch.bfloat16)
            k3._launch(y, y, y, True, 128, 128, route=route)
        with pytest.raises(ValueError, match="cuda"):
            k3._launch(x, x.cpu(), x, True, 128, 128, route=route)
    with pytest.raises(ValueError, match="sm90"):  # fp32 is never run as TF32
        k3._launch(x, x, x, True, 128, 128, route="sm90")
    assert (k3.opope_attention.launches, k3.opope_attention.launches_by_route) == before


SCAN_SHAPES = [(128, 64), (100, 3), (13, 1), (70, 300), (4096, 2048)]


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)],
                         ids=["fp32", "bf16", "fp32-bf16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scan_kernel_matches_plain_bitwise(cuda_device, shape, dtypes):
    s, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    decay = (0.2 + 0.79 * torch.rand((s, d), generator=gen, device=cuda_device)).to(dtypes[0])
    update = torch.randn((s, d), generator=gen, device=cuda_device).to(dtypes[1])
    before = tscan.opope_chunked_scan.launches
    got = tscan.opope_chunked_scan(decay, update)
    torch.cuda.synchronize()
    assert tscan.opope_chunked_scan.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, tscan.opope_chunked_scan_plain(decay, update))


def test_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.ones((4, 3), device=cuda_device)
    with pytest.raises(ValueError, match="takes"):
        tscan.opope_chunked_scan(x.half(), x)
    with pytest.raises(ValueError, match="cuda"):
        tscan.opope_chunked_scan(x, x.cpu())
