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
    a = torch.ones((4, 8), device=cuda_device, dtype=torch.float64)
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
    a = torch.ones((2, 4, 8), device=cuda_device, dtype=torch.float64)
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


def _chunk_inputs(cfg, device, rows=4, lb=32, w=8):
    """Caches with a random history and one chunk at mixed offsets: a
    prompt start, a resume, a chunk running past the bucket, a sentinel."""
    rng = np.random.default_rng(2)
    fused = cfg.n_kv * cfg.head_dim_
    caches = api.init_state(cfg, rows, lb, torch.float32, device)
    for c in caches:
        c.k.copy_(torch.from_numpy(rng.normal(size=(rows, lb, fused)).astype(np.float32)))
        c.v.copy_(torch.from_numpy(rng.normal(size=(rows, lb, fused)).astype(np.float32)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (rows, w))).to(device)
    offsets = torch.tensor([0, 13, 28, lb], device=device)
    last_idx = torch.tensor([7, 3, 3, 0], device=device)
    return toks, caches, offsets, last_idx


def test_chunk_step_on_the_card_matches_the_cpu(cuda_device):
    """api.prefill_chunk on the card (fp32: K1's tile route) against the
    same step on the CPU (the plain GEMM): logits and K/V within the fp32
    tolerance; the dropped writes leave the history bit for bit."""
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(), n_layers=2)
    params = api.init_params(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    params_dev = _to(params, cuda_device)
    want, want_c = api.prefill_chunk(cfg, params, *_chunk_inputs(cfg, "cpu"))
    inputs = _chunk_inputs(cfg, cuda_device)
    history = [c.k.clone() for c in inputs[1]]
    before = opope_gemm.launches
    with torch.inference_mode():
        got, got_c = api.prefill_chunk(cfg, params_dev, *inputs)
    assert opope_gemm.launches - before == 7 * cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3 * max(1.0, want.abs().max().item()))
    for g, w, h in zip(got_c, want_c, history):
        torch.testing.assert_close(g.k.cpu(), w.k, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(g.v.cpu(), w.v, rtol=1e-4, atol=1e-3)
        assert torch.equal(g.k[3], h[3]) and torch.equal(g.k[0, 8:], h[0, 8:])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quantized_decode_step_on_the_card_matches_the_cpu(cuda_device, fmt):
    """One api.decode_at over a quantized pool on the card (fp32 weights)
    against the CPU: logits within the fp32 tolerance, and the appended
    codes written at each row's own position (fp8 moves as bytes)."""
    from repro_torch.serve import SlotPool

    cfg = get_config("chatglm3-6b").reduced()
    params = api.init_params(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    outs = []
    for device, p in (("cpu", params), (cuda_device, _to(params, cuda_device))):
        with torch.inference_mode():
            _, caches = api.prefill_bucketed(cfg, p, toks.to(device),
                                             torch.tensor([12, 9], device=device), torch.float32)
            pool = SlotPool.create(cfg, 3, 24, torch.float32, device, kv_format=fmt)
            pool.join(caches, [2, 0])
            pos = torch.tensor([9, 0, 12], device=device)
            logits, new = api.decode_at(cfg, p, torch.tensor([[5], [0], [7]], device=device),
                                        pool.caches, pos)
        outs.append((logits.cpu(), [(c.k.view(torch.uint8) if c.k.element_size() == 1
                                     else c.k).cpu() for c in new]))
    (want, want_k), (got, got_k) = outs
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], rtol=1e-4,
                               atol=1e-3 * max(1.0, want.abs().max().item()))
    for g, w in zip(got_k, want_k):
        assert (g[0, :9] == w[0, :9]).all() and (g[2, :12] == w[2, :12]).all()
        assert (g[0, 9] != 0).any() and (g[2, 12] != 0).any()


def test_chunked_prefix_cached_int8_serve_runs_on_the_kernels(cuda_device, monkeypatch):
    """Chunked prefill, the prefix cache and an int8 pool on a reduced bf16
    model: every GEMM on K1's sm90 route, one forward per decode or chunk
    step, prefix hits, outputs of the right length."""
    from repro_torch.serve import continuous, shared_prefix_trace

    cfg = _reduced_bf16()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    chunk_steps = []

    def counting(*a, **kw):
        chunk_steps.append(1)
        return orig(*a, **kw)

    orig = continuous.model_api.prefill_chunk
    monkeypatch.setattr(continuous.model_api, "prefill_chunk", counting)
    trace = shared_prefix_trace(6, seed=1, vocab=cfg.vocab, prefix_len=40, tail_lens=(3, 9),
                                gen_lens=(3, 6), mean_interarrival=1.0)
    eng = ContinuousEngine(cfg=cfg, params=params, n_slots=2, max_len=64, prefill_chunk=16,
                           prefix_cache=True, prefix_block=16, kv_format="int8")
    before, routes = opope_gemm.launches, dict(opope_gemm.launches_by_route)
    report = eng.serve(trace)
    launches = opope_gemm.launches - before
    assert launches == 7 * cfg.n_layers * (report.decode_steps + len(chunk_steps))
    assert opope_gemm.launches_by_route["sm90"] - routes["sm90"] == launches
    assert eng.prefix_cache_stats()["hits"] > 0
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
        opope_attention_bhsd(x.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="dtype"):
        opope_attention_bhsd(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.ones((1, 1, 8, 0), device=cuda_device)
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
            k3._launch(x.double(), x.double(), x.double(), True, 128, 128, route=route)
        with pytest.raises(ValueError, match="head dims"):
            y = torch.ones((1, 1, 8, 0), device=cuda_device, dtype=torch.bfloat16)
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
        tscan.opope_chunked_scan(x.double(), x)
    with pytest.raises(ValueError, match="cuda"):
        tscan.opope_chunked_scan(x, x.cpu())


# Autograd through K1 (`ops._Matmul`): the vjp on the kernels against the
# vjp on the plain backend, the same inputs and cotangent. fp32 gradients
# within rtol 1e-4 / atol 1e-3 of the plain ones; bf16 within 2e-2 of the
# largest magnitude (each backward GEMM rounds to bf16, and an epilogue'd
# product's fp32 cotangent comes from a recomputed accumulator whose sums
# run in another order than the plain version's).
VJP_SHAPES = [(64, 256, 128), (5, 40, 24), (130, 136, 264)]


def _vjp(a, b, operands, spec, g, c, backend):
    inputs = [a, b] + ([c] if c is not None else []) + operands
    out = ops.matmul(a, b, c, backend=backend, epilogue=spec)
    return out, torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", VJP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_vjp_matches_the_plain_backend(cuda_device, shape, dtype):
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m * k + n)

    def rand(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=cuda_device) * scale).to(dtype)

    a, b = rand(m, k).requires_grad_(), rand(k, n, scale=k ** -0.5).requires_grad_()
    g = rand(m, n)
    cases = [(None, [], None), (rand(n).requires_grad_(), [], None),
             (rand(m, n).requires_grad_(), [], None)]
    for op in tep.epilogue_ops():
        kind = tep.op_kind(op)
        o = {"none": None, "row": rand(n), "full": rand(m, n),
             "scalar": torch.tensor(0.05, device=cuda_device)}[kind]
        if o is None:
            cases.append((None, [], [op]))
        else:
            o.requires_grad_()
            cases.append((None, [o], [(op, o)]))
    up = rand(m, n).requires_grad_()  # a bias folded into the SwiGLU gate's chain
    cases.append((rand(n).requires_grad_(), [up], ["silu", ("mul", up)]))
    for c, operands, spec in cases:
        out, got = _vjp(a, b, operands, spec, g, c, "cuda")
        assert isinstance(out.grad_fn, ops._Matmul._backward_cls)
        _, want = _vjp(a, b, operands, spec, g, c, "torch")
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            if dtype == torch.float32:
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-3)
            else:
                assert (x.float() - y.float()).abs().max() <= 2e-2 * y.float().abs().max()


def test_k1_backward_launches_by_route(cuda_device):
    """bf16 at M = 64: a plain product's backward is 2 sm90 launches; an
    epilogue'd one recomputes its fp32 accumulator on sm90 and runs dA, dB
    on the fp32 cotangent on the tile route. Neither counts into calls."""
    k1 = _k1_module()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn((64, 256), generator=gen, device=cuda_device).to(torch.bfloat16)
    b = torch.randn((256, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
    r = torch.randn((64, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
    for spec, want in ((None, {"sm90": 2, "tile": 0}),
                       ([("residual", r)], {"sm90": 1, "tile": 2})):
        a_, b_ = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = ops.matmul(a_, b_, epilogue=spec)
        calls = ops.backend("cuda").calls
        k1.opope_gemm.launches_by_route.update(sm90=0, tile=0)
        torch.autograd.grad(out, [a_, b_], torch.ones_like(out))
        torch.cuda.synchronize()
        assert k1.opope_gemm.launches_by_route == want
        assert ops.backend("cuda").calls == calls


def test_reduced_model_loss_and_gradients_on_the_kernels_match_the_plain_backend(cuda_device):
    """fp32 reduced chatglm3-6b (the tile route throughout): the loss within
    1e-5 relative and every gradient leaf within rtol 1e-3 / atol 1e-5 of
    the plain backend's; then three train steps on the kernels."""
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_leaves

    cfg = get_config("chatglm3-6b").reduced()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch_fn(MarkovLMDataset(cfg.vocab, 32, 4), cuda_device)(0)

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = api.loss_fn(cfg, live, batch, backend=backend)
        return loss, torch.autograd.grad(loss, list(leaves(live)))

    loss_k, g_k = loss_grads("cuda")
    loss_p, g_p = loss_grads("torch")
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    for x, y in zip(g_k, g_p):
        torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)
    opt = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    step, state = make_train_step(cfg, opt), init_opt_state(params, opt)
    before = opope_gemm.launches
    losses = [float(step(params, state, batch)[2]["loss"]) for _ in range(3)]
    assert opope_gemm.launches - before == 3 * (7 + 7 + 8 + 9) * cfg.n_layers
    assert losses[-1] < losses[0]


# The registry contract on the card: the `cuda` and `cuda_q8` members on
# CUDA tensors against their plain twins (`torch`, `torch_q8`) on the same
# tensors, with the conformance suite's tolerances (fp: 1e-4 x max|want| +
# 1e-5 at fp32 in; q8: bitwise where the chain has no transcendental op).
CARD_MEMBERS = {"cuda": "torch", "cuda_q8": "torch_q8"}


def _card_tol(name, want):
    if ops.family_of(name) == "q8":
        return 0.03 * float(want.abs().max())
    return 1e-4 * float(want.abs().max()) + 1e-5


def _runtime_op(monkeypatch, name="_test_softsign"):
    """Register a run-time op (no kernel code); undone at teardown."""
    monkeypatch.setitem(tep._REGISTRY, name, tep._REGISTRY.get(name))
    tep.register_epilogue_op(name, "none", lambda acc, _o: acc / (1.0 + acc.abs()))
    return name


@pytest.mark.parametrize("lane", ["fused", "post-hoc"])
@pytest.mark.parametrize("name", sorted(CARD_MEMBERS))
def test_card_members_keep_the_registry_contract(cuda_device, name, lane, monkeypatch):
    plain = CARD_MEMBERS[name]
    if lane == "post-hoc":
        monkeypatch.setattr(ops.backend(name), "epilogue_fused", False)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    a = torch.randn((48, 96), generator=gen, device=cuda_device)
    b = torch.randn((96, 72), generator=gen, device=cuda_device)
    ga = torch.randn((3, 24, 64), generator=gen, device=cuda_device)
    gb = torch.randn((3, 64, 40), generator=gen, device=cuda_device)
    bias = torch.randn((72,), generator=gen, device=cuda_device)
    gbias = torch.randn((3, 40), generator=gen, device=cuda_device)
    gate = torch.randn((48, 72), generator=gen, device=cuda_device)

    def close(got, want):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert (got.float() - want.float()).abs().max() <= _card_tol(name, want.float())

    close(ops.matmul(a, b, backend=name), ops.matmul(a, b, backend=plain))
    wide = ops.matmul(a, b, backend=name, out_dtype=torch.float32)
    assert torch.equal(ops.matmul(a, b, backend=name, out_dtype=torch.bfloat16),
                       wide.to(torch.bfloat16))
    close(ops.matmul(a, b, bias, backend=name), ops.matmul(a, b, bias, backend=plain))
    close(ops.grouped_matmul(ga, gb, gbias, backend=name),
          ops.grouped_matmul(ga, gb, gbias, backend=plain))
    for spec in ("gelu", "relu", [("bias", bias), "gelu"], ["silu", ("mul", gate)],
                 [("residual", gate)], [("scale", bias)],
                 [("requant_int8", torch.tensor(0.05, device=cuda_device))]):
        got = ops.matmul(a, b, backend=name, epilogue=spec, out_dtype=torch.float32)
        want = ops.matmul(a, b, backend=plain, epilogue=spec, out_dtype=torch.float32)
        extra = 1.0 if isinstance(spec, list) and spec[0][0] == "requant_int8" else 0.0
        assert (got - want).abs().max() <= _card_tol(name, want) + extra
        narrow = ops.matmul(a, b, backend=name, epilogue=spec, out_dtype=torch.bfloat16)
        assert torch.equal(narrow, got.to(torch.bfloat16))
    stacked = torch.stack([ops.matmul(ga[i], gb[i], backend=name, epilogue=[
        ("bias", gbias[i]), "silu"]) for i in range(3)])
    got = ops.grouped_matmul(ga, gb, backend=name, epilogue=[("bias", gbias), "silu"])
    assert (got - stacked).abs().max() <= 1e-4 * float(stacked.abs().max()) + 1e-5
    # Under autograd both families' backward runs on the fp grad backend
    # (K1, K4 for the card members): with a cotangent of ones the gradients
    # do not depend on the forward's numerics.
    x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
    gx, gy = ga.clone().requires_grad_(), gb.clone().requires_grad_()
    for fn, args in ((ops.matmul, (x, y)), (ops.grouped_matmul, (gx, gy))):
        got = torch.autograd.grad(fn(*args, backend=name, epilogue="silu").sum(), args)
        want = torch.autograd.grad(fn(*args, backend=plain, epilogue="silu").sum(), args)
        for u, v in zip(got, want):
            torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_runtime_op_runs_post_hoc_on_k1_and_k4(cuda_device, dtype, monkeypatch):
    """A run-time op on the `cuda` member: one fp32-output launch of K1 (K4
    for the grouped call), then the chain and one cast, equal to the plain
    member's post-hoc result within the contract's tolerance."""
    op = _runtime_op(monkeypatch)
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    a = torch.randn((64, 256), generator=gen, device=cuda_device).to(dtype)
    b = (torch.randn((256, 128), generator=gen, device=cuda_device) / 16).to(dtype)
    ga = torch.randn((4, 60, 256), generator=gen, device=cuda_device).to(dtype)
    gb = (torch.randn((4, 256, 128), generator=gen, device=cuda_device) / 16).to(dtype)
    for fn, x, y, kern in ((ops.matmul, a, b, opope_gemm),
                           (ops.grouped_matmul, ga, gb, tg.opope_gemm_grouped)):
        before = kern.launches
        got = fn(x, y, backend="cuda", epilogue=[op, "relu"])
        torch.cuda.synchronize()
        assert kern.launches == before + 1 and got.dtype == dtype
        acc = fn(x, y, backend="cuda", out_dtype=torch.float32)
        assert torch.equal(got, tep.apply_epilogue(acc, (op, "relu"), ()).to(dtype))
        want = fn(x, y, backend="torch", epilogue=[op, "relu"], out_dtype=torch.float32)
        assert (got.float() - want).abs().max() <= 1e-2 * float(want.abs().max()) + 1e-5


def test_kernel_wrappers_refuse_an_op_without_a_kernel_code(cuda_device, monkeypatch):
    """K1, K2, K4 and K5 on CUDA tensors raise on a code-less op, and on a
    built-in replaced at run time, before any launch."""
    op = _runtime_op(monkeypatch)
    dev = cuda_device
    a, b = torch.ones((8, 32), device=dev), torch.ones((32, 16), device=dev)
    ga, gb = torch.ones((2, 8, 32), device=dev), torch.ones((2, 32, 16), device=dev)
    qa, qb = torch.ones((8, 32), device=dev, dtype=torch.int8), torch.ones((32, 16), device=dev,
                                                                            dtype=torch.int8)
    sa, sb = torch.ones((8, 1), device=dev), torch.ones((1, 16), device=dev)
    for chain in ((op,), ("relu", op)):
        launches = (opope_gemm.launches, tg.opope_gemm_grouped.launches,
                    tq8.opope_gemm_q8.launches, tq8.opope_gemm_q8_grouped.launches)
        with pytest.raises(ValueError, match="no kernel code"):
            tg.opope_gemm_grouped(ga, gb, epilogue=chain)
        with pytest.raises(ValueError, match="no kernel code"):
            opope_gemm(a, b, epilogue=chain)
        with pytest.raises(ValueError, match="no kernel code"):
            tq8.opope_gemm_q8(qa, sa, qb, sb, epilogue=chain)
        with pytest.raises(ValueError, match="no kernel code"):
            tq8.opope_gemm_q8_grouped(qa.expand(2, 8, 32).contiguous(), sa.expand(2, 8, 1).contiguous(),
                                      qb.expand(2, 32, 16).contiguous(),
                                      sb.expand(2, 1, 16).contiguous(), epilogue=chain)
        assert launches == (opope_gemm.launches, tg.opope_gemm_grouped.launches,
                            tq8.opope_gemm_q8.launches, tq8.opope_gemm_q8_grouped.launches)
    monkeypatch.setitem(tep._REGISTRY, "silu", tep._REGISTRY["silu"])
    tep.register_epilogue_op("silu", "none", lambda acc, _o: acc * torch.sigmoid(acc))
    with pytest.raises(ValueError, match="no kernel code"):
        tg.opope_gemm_grouped(ga, gb, epilogue=("silu",))
    # ...while the entry point runs that chain post-hoc on K4.
    before = tg.opope_gemm_grouped.launches
    got = ops.grouped_matmul(ga, gb, backend="cuda", epilogue="silu")
    assert tg.opope_gemm_grouped.launches == before + 1
    torch.testing.assert_close(got, torch.nn.functional.silu(torch.full_like(got, 32.0)))


# Autograd through K4 (`ops._GroupedMatmul`): the vjp on the kernels against
# the vjp on the plain backend, the tolerances of the K1 vjp test above.
GROUPED_VJP_SHAPES = [(3, 64, 256, 128), (3, 5, 40, 24), (64, 60, 256, 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", GROUPED_VJP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_vjp_matches_the_plain_backend(cuda_device, shape, dtype):
    g_, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g_ + m * k + n)

    def rand(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=cuda_device) * scale).to(dtype)

    a = rand(g_, m, k).requires_grad_()
    b = rand(g_, k, n, scale=k ** -0.5).requires_grad_()
    g = rand(g_, m, n)
    cases = [(None, [], None), (rand(g_, n).requires_grad_(), [], None),
             (rand(g_, m, n).requires_grad_(), [], None)]
    for op in tep.epilogue_ops():
        o = {"none": None, "row": rand(g_, n), "full": rand(g_, m, n),
             "scalar": torch.tensor(0.05, device=cuda_device)}[tep.op_kind(op)]
        if o is None:
            cases.append((None, [], [op]))
        else:
            cases.append((None, [o.requires_grad_()], [(op, o)]))
    up = rand(g_, m, n).requires_grad_()  # the experts' gate chain
    cases.append((None, [up], ["silu", ("mul", up)]))
    for c, operands, spec in cases:
        inputs = [a, b] + ([c] if c is not None else []) + operands
        out = ops.grouped_matmul(a, b, c, backend="cuda", epilogue=spec)
        assert isinstance(out.grad_fn, ops._GroupedMatmul._backward_cls)
        got = torch.autograd.grad(out, inputs, g)
        out_p = ops.grouped_matmul(a, b, c, backend="torch", epilogue=spec)
        want = torch.autograd.grad(out_p, inputs, g)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            if dtype == torch.float32:
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-3)
            else:
                assert (x.float() - y.float()).abs().max() <= 2e-2 * y.float().abs().max()


def test_k4_backward_launches_by_route(cuda_device):
    """bf16 experts at deepseek's training shapes (4 routing groups at
    capacity 60: 240 rows): a plain product's backward is 2 sm90 launches of
    K4; the gate chain's recomputes its fp32 accumulator on sm90 and runs
    dA, dB on the fp32 cotangent on the tile route; w_down's fp32 output
    takes an fp32 cotangent, 2 tile launches. None counts into
    grouped_calls. (At 60 rows dB's K of 60 gives 120-byte rows, which only
    the tile route takes.)"""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    xs = torch.randn((64, 240, 2048), generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn((64, 2048, 1408), generator=gen, device=cuda_device) / 45).bfloat16()
    w_down = (torch.randn((64, 1408, 2048), generator=gen, device=cuda_device) / 38).bfloat16()
    up = torch.randn((64, 240, 1408), generator=gen, device=cuda_device).bfloat16()
    for x, y, spec, out_dtype, want in (
            (xs, w, None, None, {"sm90": 2, "tile": 0}),
            (xs, w, ["silu", ("mul", up)], None, {"sm90": 1, "tile": 2}),
            (up, w_down, None, torch.float32, {"sm90": 0, "tile": 2})):
        x_, y_ = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = ops.grouped_matmul(x_, y_, backend="cuda", epilogue=spec, out_dtype=out_dtype)
        calls = ops.backend("cuda").grouped_calls
        tg.opope_gemm_grouped.launches_by_route.update(sm90=0, tile=0)
        torch.autograd.grad(out, [x_, y_], torch.ones_like(out))
        torch.cuda.synchronize()
        assert tg.opope_gemm_grouped.launches_by_route == want
        assert ops.backend("cuda").grouped_calls == calls


def test_reduced_deepseek_loss_and_gradients_on_the_kernels_match_the_plain_backend(
        cuda_device):
    """fp32 reduced deepseek-moe-16b (the tile routes throughout): the loss
    within 1e-5 relative and every gradient leaf within rtol 1e-3 / atol
    1e-5 of the plain backend's; then three train steps on the kernels, K1
    and K4 launched exactly as counted a layer and a step."""
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, map_leaves

    cfg = get_config("deepseek-moe-16b").reduced()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch_fn(MarkovLMDataset(cfg.vocab, 32, 4), cuda_device)(0)

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = api.loss_fn(cfg, live, batch, backend=backend)
        return loss, torch.autograd.grad(loss, list(leaves(live)))

    loss_k, g_k = loss_grads("cuda")
    loss_p, g_p = loss_grads("torch")
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    for x, y in zip(g_k, g_p):
        torch.testing.assert_close(x, y, rtol=1e-3, atol=1e-5)
    opt = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    step, state = make_train_step(cfg, opt), init_opt_state(params, opt)
    k1, k4 = opope_gemm.launches, tg.opope_gemm_grouped.launches
    losses = [float(step(params, state, batch)[2]["loss"]) for _ in range(3)]
    # K1 a layer: 8 forward + 8 remat + 10 plain backward + 3 recomputes +
    # 6 on the fp32 cotangent; K4: 3 + 3 + 2 + 1 + 4.
    assert opope_gemm.launches - k1 == 3 * (8 + 8 + 10 + 3 + 6) * cfg.n_layers
    assert tg.opope_gemm_grouped.launches - k4 == 3 * (3 + 3 + 2 + 1 + 4) * cfg.n_layers
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# q8 training on the card: a `cuda_q8` forward (K2, K5) with its backward on
# K1 and K4. Its gradients are the `cuda` backend's vjp, bit for bit (the
# same rules on the grad backend, the same saved inputs and cotangent; K1
# and K4 are deterministic), and within the bf16 tolerance of
# test_k1_vjp_matches_the_plain_backend (2e-2 of the largest magnitude) of
# the `torch_q8` vjp, whose backward is the plain fp backend's. The
# same-run fp32/fp64 floor gate runs at the models' shapes in chip_smoke.py
# phase 12: at these few-thousand-element bf16 outputs the floor counts a
# handful of rounding flips.
@pytest.mark.parametrize("form", ["none", "bias", "full", "chain"])
@pytest.mark.parametrize("grouped", [False, True], ids=["k2", "k5"])
def test_cuda_q8_vjp_runs_the_fp_backward(cuda_device, grouped, form):
    gen = torch.Generator(device=cuda_device).manual_seed(28)
    lead = (3,) if grouped else ()
    m, k, n = 64, 256, 128

    def rand(*shape, scale=1.0):
        return (torch.randn(lead + shape, generator=gen, device=cuda_device) * scale).to(
            torch.bfloat16).requires_grad_()

    a, b = rand(m, k), rand(k, n, scale=k ** -0.5)
    c, spec, extra = None, None, []
    if form == "bias":
        c = rand(n)
    elif form == "full":
        c = rand(m, n)
    elif form == "chain":
        row, full = rand(n), rand(m, n)
        spec, extra = [("bias", row), "silu", ("mul", full)], [row, full]
    inputs = [a, b] + ([c] if c is not None else []) + extra
    g = torch.randn(lead + (m, n), generator=gen, device=cuda_device).to(torch.bfloat16)
    fn = ops.grouped_matmul if grouped else ops.matmul
    kern = tq8.opope_gemm_q8_grouped if grouped else tq8.opope_gemm_q8
    fp_kern = tg.opope_gemm_grouped if grouped else opope_gemm

    def vjp(backend):
        out = fn(a, b, c, backend=backend, epilogue=spec)
        return out, torch.autograd.grad(out, inputs, g)

    before = (kern.launches, fp_kern.launches)
    out, got = vjp("cuda_q8")
    torch.cuda.synchronize()
    assert kern.launches - before[0] == 1  # the forward on K2 / K5, the backward not
    assert fp_kern.launches - before[1] == (3 if spec else 2)
    with torch.no_grad():
        assert torch.equal(out, fn(a, b, c, backend="cuda_q8", epilogue=spec))
    _, fp = vjp("cuda")
    _, want = vjp("torch_q8")
    for x, y, z in zip(got, fp, want):
        assert x.dtype == z.dtype and x.shape == z.shape and torch.isfinite(x.float()).all()
        assert torch.equal(x, y)
        assert (x.float() - z.float()).abs().max() <= 2e-2 * z.float().abs().max()


def _aligned_moe(cfg):
    """Reduced deepseek-moe-16b whose router N and expert rows plan sm90 as
    at full width: 8 experts, capacity-dropped onehot groups of 32."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False, group_size=32, n_experts=8, capacity_factor=1.5))


# Launches a layer of one q8 train step, by kernel and route (chip_smoke.py
# phase 12's tables): the quantized roles' forward and remat recompute on K2
# and K5, every backward GEMM on K1 and K4, the fp32 ones on the tile route.
@pytest.mark.parametrize("arch,policy,per_layer", [
    ("chatglm3-6b", mlp_q8_policy(),
     {"K1": {"sm90": 19, "tile": 6}, "K2": {"sm90": 6, "tile": 0},
      "K4": {"sm90": 0, "tile": 0}, "K5": {"sm90": 0, "tile": 0}}),
    ("deepseek-moe-16b", PrecisionPolicy(rules={"moe": "q8"}),
     {"K1": {"sm90": 23, "tile": 6}, "K2": {"sm90": 6, "tile": 0},
      "K4": {"sm90": 3, "tile": 4}, "K5": {"sm90": 6, "tile": 0}}),
], ids=["chatglm3-6b", "deepseek-moe-16b"])
def test_q8_train_step_launches_by_route(cuda_device, arch, policy, per_layer):
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    cfg = _reduced_bf16(arch)
    if cfg.moe is not None:
        cfg = _aligned_moe(cfg)
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch_fn(MarkovLMDataset(cfg.vocab, 32, 4), cuda_device)(0)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    step, state = make_train_step(cfg, opt, policy=policy), init_opt_state(params, opt)
    kernels = {"K1": opope_gemm, "K2": tq8.opope_gemm_q8, "K4": tg.opope_gemm_grouped,
               "K5": tq8.opope_gemm_q8_grouped}
    before = {k: dict(v.launches_by_route) for k, v in kernels.items()}
    loss = float(step(params, state, batch)[2]["loss"])
    torch.cuda.synchronize()
    got = {k: {r: v.launches_by_route[r] - before[k][r] for r in ("sm90", "tile")}
           for k, v in kernels.items()}
    assert got == {k: {r: x * cfg.n_layers for r, x in v.items()} for k, v in per_layer.items()}
    assert np.isfinite(loss)


def test_bf16_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A reduced bf16 model's parameters and AdamW state saved from the card
    and restored onto it, bit for bit, bf16 staying bf16."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.tree import leaves, map_leaves

    cfg = _reduced_bf16()
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    st = init_opt_state(params, AdamWConfig())
    st = st._replace(mu=map_leaves(lambda x: torch.randn(x.shape, generator=gen,
                                                         device=cuda_device), st.mu))
    tree = {"params": params, "opt": st}
    ckpt.save(str(tmp_path), 3, tree)
    back = ckpt.restore(str(tmp_path), 3, tree, cuda_device)
    for x, y in zip(leaves(back), leaves(tree)):
        assert x.device.type == "cuda" and x.dtype == y.dtype and torch.equal(x, y)
    assert any(x.dtype == torch.bfloat16 for x in leaves(back["params"]))


# --- tuning: every candidate plan of K1, K2, K4, K5 (repro_torch.tune) --------------------

# (m, k, n): decode and prefill rows on both tiles, the 8-row int8 tile at
# M 30 and 60, K tails (1000 = 15 full 64-element panels + 40, 8 int8
# panels of 128 - a split of the last short), split counts to the ladder's
# largest legal one.
PLAN_SHAPES = [(4, 1000, 512), (30, 1024, 512), (60, 1024, 256), (512, 1024, 256)]
PLAN_FORMS = [("none", None, ()), ("bias+silu", "row", ("silu",)), ("full+mul", "full", ("mul",))]


def _plan_forms(gen, dev, lead, m, n, dtype):
    """(label, c, steps, operands): without C or chain; an [N] (or [G, N]) C
    and silu; a full C and a full ``mul`` operand."""
    row = torch.randn(lead + (n,), generator=gen, device=dev).to(dtype)
    full = torch.randn(lead + (m, n), generator=gen, device=dev).to(dtype)
    mul = torch.randn(lead + (m, n), generator=gen, device=dev).to(dtype)
    return [("none", None, (), ()), ("bias+silu", row, ("silu",), ()),
            ("full+mul", full, ("mul",), (mul,))]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_k1_plan_matches_plain(cuda_device, shape):
    m, k, n = shape
    k1 = _k1_module()
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).to(torch.bfloat16)
    plans = k1.candidate_plans(m, n, k)
    assert {p.bm for p in plans} == {64, 128} and max(p.splits for p in plans) > 1
    for plan in plans:
        for label, c, steps, ops_ in _plan_forms(gen, cuda_device, (), m, n, torch.bfloat16):
            before = dict(opope_gemm.launches_by_route)
            got = opope_gemm(a, b, c, epilogue=steps, epilogue_operands=ops_, plan=plan)
            assert opope_gemm.launches_by_route["sm90"] == before["sm90"] + 1
            _check(got, a, b, c, torch.bfloat16, steps, ops_)
        if plan.splits > 1:  # split-K stays deterministic under a forced split
            assert torch.equal(opope_gemm(a, b, plan=plan), opope_gemm(a, b, plan=plan))


@pytest.mark.parametrize("shape", [(1, 1000, 256), (30, 1024, 256), (60, 520, 264),
                                   (130, 256, 128)], ids=lambda s: "x".join(map(str, s)))
def test_every_k4_plan_matches_plain(cuda_device, shape):
    m, k, n = shape
    g = 8
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    b = (torch.randn((g, k, n), generator=gen, device=cuda_device) * k ** -0.5).to(torch.bfloat16)
    plans = tg.candidate_plans(m, n, k)
    assert [(p.bm, p.splits) for p in plans] == [(64, 1), (128, 1)]
    for plan in plans:
        for label, c, steps, ops_ in _plan_forms(gen, cuda_device, (g,), m, n, torch.bfloat16):
            ops3 = tuple(x for x in ops_)
            got = tg.opope_gemm_grouped(a, b, c, epilogue=steps, epilogue_operands=ops3,
                                        plan=plan)
            want = tg.opope_gemm_grouped_plain(a, b, c, out_dtype=torch.float32,
                                               epilogue=steps, epilogue_operands=ops3)
            _, e = torch.frexp(want)
            tol = torch.ldexp(torch.ones_like(want), e - 8) + 1e-5 * want.abs().max()
            assert ((got.float() - want).abs() <= tol).all(), (plan, label)


@pytest.mark.parametrize("grouped", [False, True], ids=["k2", "k5"])
@pytest.mark.parametrize("shape", [(4, 1024, 512), (30, 1024, 512), (60, 1040, 256),
                                   (512, 1024, 256)], ids=lambda s: "x".join(map(str, s)))
def test_every_int8_plan_matches_plain(cuda_device, shape, grouped):
    m, k, n = shape
    lead = (8,) if grouped else ()
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + grouped)
    a, sa, b, sb = _q8_operands(gen, cuda_device, lead + (m,), k, n)
    plans = tq8.candidate_plans(m, n, k, grouped=grouped)
    assert {p.bm for p in plans} == {8, 128}
    assert grouped or max(p.splits for p in plans) > 1
    kern = tq8.opope_gemm_q8_grouped if grouped else tq8.opope_gemm_q8
    plain = tq8.opope_gemm_q8_grouped_plain if grouped else tq8.opope_gemm_q8_plain
    for plan in plans:
        for label, c, steps, ops_ in _plan_forms(gen, cuda_device, lead, m, n, torch.float32):
            got = kern(a, sa, b, sb, c, epilogue=steps, epilogue_operands=ops_, plan=plan)
            want = plain(a, sa, b, sb, c, epilogue=steps, epilogue_operands=ops_)
            _check_q8(got, want, steps[0] if steps else "none")


def test_illegal_forced_plans_raise_and_launch_nothing(cuda_device):
    k1 = _k1_module()
    a = torch.randn((4, 256), device=cuda_device).to(torch.bfloat16)
    b = torch.randn((256, 512), device=cuda_device).to(torch.bfloat16)
    before = opope_gemm.launches
    too_many = k1.Plan("sm90", 0, 64, 128, 64, 8, 5, 1, 4, ())  # 5 splits of 4 panels
    with pytest.raises(ValueError, match="empty"):
        opope_gemm(a, b, plan=too_many)
    with pytest.raises(ValueError, match="does not take"):
        opope_gemm(a.float(), b.float(), plan=k1.validate_plan(4, 512, 256, (64, 128, 64)))
    with pytest.raises(ValueError, match="never splits"):
        tg.opope_gemm_grouped(a[None], b[None], plan=k1.validate_plan(4, 512, 256,
                                                                     (64, 128, 64), 2))
    wide = torch.randn((256, 128 * 67), device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="counters"):
        opope_gemm(a, wide, plan=k1.Plan("sm90", 0, 64, 128, 64, 8, 2, 1, 67, ()))
    assert opope_gemm.launches == before
    aq, sa, bq, sb = _q8_operands(torch.Generator(device=cuda_device).manual_seed(0),
                                  cuda_device, (4,), 256, 512)
    before = tq8.opope_gemm_q8.launches
    with pytest.raises(ValueError, match="not a compiled tile"):
        tq8.opope_gemm_q8(aq, sa, bq, sb, plan=k1.validate_plan(4, 512, 256, (64, 128, 64)))
    with pytest.raises(ValueError, match="never splits"):
        tq8.opope_gemm_q8_grouped(aq[None], sa[None], bq[None], sb[None],
                                  plan=tq8.validate_plan(4, 512, 256, (8, 128, 128), 2))
    assert tq8.opope_gemm_q8.launches == before


def test_a_tuned_table_serves_the_card_members(cuda_device, tmp_path, monkeypatch):
    """With a table naming a non-heuristic plan, ``ops`` runs K1 and K2 on it
    (sm90, the plain version's result) and reports it tuned; cleared, the
    heuristic serves again."""
    from repro_torch.tune import TuneEntry, TuneKey, TuningTable, device_kind

    k1 = _k1_module()
    kind = device_kind()
    table = TuningTable([
        TuneEntry(TuneKey("cuda", "dense", 4, 1024, 512, 0, "bfloat16", kind), (128, 128, 64),
                  1.0, 1.0, splits=3),
        TuneEntry(TuneKey("cuda_q8", "dense", 30, 1024, 512, 0, "int8", kind), (8, 128, 128),
                  1.0, 1.0, splits=2, fuse_epilogue=False)])
    path = tmp_path / "t.json"
    table.save(str(path))
    monkeypatch.setenv("REPRO_TUNE_TABLE", str(path))
    ops.clear_tile_cache()
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        x = torch.randn((4, 1024), generator=gen, device=cuda_device).to(torch.bfloat16)
        w = (torch.randn((1024, 512), generator=gen, device=cuda_device) / 32).to(torch.bfloat16)
        assert ops.tile_for("cuda", 4, 1024, 512) == k1.validate_plan(4, 512, 1024,
                                                                      (128, 128, 64), 3)
        assert ops.tile_source("cuda", 4, 1024, 512) == "tuned"
        before = dict(opope_gemm.launches_by_route)
        got = ops.matmul(x, w)
        assert opope_gemm.launches_by_route["sm90"] == before["sm90"] + 1
        _check(got, x, w, None, torch.bfloat16, (), ())
        x30 = torch.randn((30, 1024), generator=gen, device=cuda_device).to(torch.bfloat16)
        assert ops.tile_for("cuda_q8", 30, 1024, 512).bm == 8
        got = ops.matmul(x30, w, backend="cuda_q8", epilogue="relu")  # post-hoc: fuse False
        want = ops.matmul(x30, w, backend="torch_q8", epilogue="relu")
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)
    finally:
        monkeypatch.delenv("REPRO_TUNE_TABLE")
        ops.clear_tile_cache()
    assert ops.tile_source("cuda", 4, 1024, 512) == "heuristic"


# The families served and trained since the sixteenth slice (ROADMAP A.8),
# at their published widths: K1 at every distinct projection shape of
# qwen2.5-32b, stablelm-12b and gemma2-9b at a 4-row decode step, and
# grok-1-314b's router (N = 8) at 4 and 512 rows; K4 and K5 at grok's expert
# GEMMs (G 8, 6144 -> 32768 and 32768 -> 6144) at a 4-row decode step's
# capacity (2), a 2 x 64 prefill's (40) and a 512-token group's (160); K2 at
# qwen2.5's MLP at 4 and 512 rows. Each runs the chains the model runs there.
def _family_k1_shapes():
    shapes = {(4, 6144, 8), (512, 6144, 8)}
    for arch in ("qwen2.5-32b", "stablelm-12b", "gemma2-9b"):
        c = get_config(arch)
        d, hq, hkv, f = c.d_model, c.n_heads * c.head_dim_, c.n_kv * c.head_dim_, c.d_ff
        shapes |= {(4, d, hq), (4, d, hkv), (4, hq, d), (4, d, f), (4, f, d)}
    return sorted(shapes)


FAMILY_K1_SHAPES = _family_k1_shapes()
GROK_EXPERT_SHAPES = [(8, m, k, n) for m in (2, 40, 160) for k, n in ((6144, 32768),
                                                                       (32768, 6144))]
QWEN_MLP_SHAPES = [(m, k, n) for m in (4, 512) for k, n in ((5120, 27648), (27648, 5120))]


@pytest.mark.parametrize("shape", FAMILY_K1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_at_the_new_families_shapes_matches_plain(cuda_device, shape):
    """Plain, with qwen2.5's QKV bias as C, with the residual (wo, w_down)
    and with silu·mul (w_gate), every launch on sm90."""
    k1 = _k1_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert k1._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    bias = torch.randn((n,), generator=gen, device=cuda_device).bfloat16()
    full = torch.randn((m, n), generator=gen, device=cuda_device).bfloat16()
    for c, steps, operands in ((None, (), ()), (bias, (), ()), (None, ("residual",), (full,)),
                               (None, ("silu", "mul"), (full,))):
        before = dict(opope_gemm.launches_by_route)
        got = opope_gemm(a, b, c, epilogue=steps, epilogue_operands=operands)
        torch.cuda.synchronize()
        assert opope_gemm.launches_by_route == dict(before, sm90=before["sm90"] + 1)
        _check(got, a, b, c, torch.bfloat16, steps, operands)


def _grok_expert_chains(k, up):
    """The chains grok's experts run at a shape: w_up (bf16 out) and w_gate
    with silu·mul (bf16 out) at 6144 -> 32768; w_down at 32768 -> 6144 in
    fp32 out, as the dispatch combines in fp32."""
    if k == 32768:
        return (((), (), torch.float32),)
    return (((), (), torch.bfloat16), (("silu", "mul"), (up,), torch.bfloat16))


@pytest.mark.parametrize("shape", GROK_EXPERT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_at_groks_expert_shapes_matches_plain(cuda_device, shape):
    """Each expert GEMM's chain (:func:`_grok_expert_chains`), every launch
    on sm90, bitwise on repeat."""
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((g, k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert tg._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    up = torch.randn((g, m, n), generator=gen, device=cuda_device).bfloat16()
    for steps, operands, out_dtype in _grok_expert_chains(k, up):
        before = dict(tg.opope_gemm_grouped.launches_by_route)
        got = tg.opope_gemm_grouped(a, b, out_dtype=out_dtype, epilogue=steps,
                                    epilogue_operands=operands)
        again = tg.opope_gemm_grouped(a, b, out_dtype=out_dtype, epilogue=steps,
                                      epilogue_operands=operands)
        torch.cuda.synchronize()
        assert tg.opope_gemm_grouped.launches_by_route == dict(before, sm90=before["sm90"] + 2)
        assert torch.equal(got, again)
        _check(got, a, b, None, out_dtype, steps, operands, plain=tg.opope_gemm_grouped_plain)


@pytest.mark.parametrize("shape", GROK_EXPERT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k5_at_groks_expert_shapes_matches_plain(cuda_device, shape):
    """grok under {"moe": "q8"}: each expert GEMM's chain, bitwise against
    the plain version but the transcendental op (one ulp), every launch on
    sm90."""
    q8 = _q8_module()
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (g, m), k, n)
    assert _k5_route(a, b) == "sm90"
    up = torch.randn((g, m, n), generator=gen, device=cuda_device).bfloat16()
    kern = q8.opope_gemm_q8_grouped
    for steps, operands, out_dtype in _grok_expert_chains(k, up):
        before = dict(kern.launches_by_route)
        got = kern(a, sa, b, sb, out_dtype=out_dtype, epilogue=steps, epilogue_operands=operands)
        torch.cuda.synchronize()
        assert kern.launches_by_route == dict(before, sm90=before["sm90"] + 1)
        want = q8.opope_gemm_q8_grouped_plain(a, sa, b, sb, out_dtype=out_dtype, epilogue=steps,
                                              epilogue_operands=operands)
        _check_q8(got, want, steps[0] if steps else "none")


@pytest.mark.parametrize("shape", QWEN_MLP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_at_qwens_mlp_shapes_matches_plain(cuda_device, shape):
    """qwen2.5-32b under mlp_q8_policy(): w_up, w_gate with silu·mul and
    w_down with the residual, bitwise against the plain version but the
    transcendental op (one ulp), every launch on sm90."""
    q8 = _q8_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a, sa, b, sb = _q8_operands(gen, cuda_device, (m,), k, n)
    assert _k2_route(a, b) == "sm90"
    full = torch.randn((m, n), generator=gen, device=cuda_device).bfloat16()
    for steps, operands in (((), ()), (("silu", "mul"), (full,)), (("residual",), (full,))):
        before = dict(q8.opope_gemm_q8.launches_by_route)
        got = q8.opope_gemm_q8(a, sa, b, sb, out_dtype=torch.bfloat16, epilogue=steps,
                               epilogue_operands=operands)
        torch.cuda.synchronize()
        assert q8.opope_gemm_q8.launches_by_route == dict(before, sm90=before["sm90"] + 1)
        want = q8.opope_gemm_q8_plain(a, sa, b, sb, out_dtype=torch.bfloat16, epilogue=steps,
                                      epilogue_operands=operands)
        _check_q8(got, want, steps[0] if steps else "none")


# llava-next-mistral-7b and whisper-base (ROADMAP A.8b) at their published
# widths: K1 at llava's projector over one image's 2880 rows (w1 with the
# GELU, w2 plain), mistral's 4096 -> 1024 (wk, wv) and 4096 -> 14336 (w_up
# plain, w_gate with silu·mul) at a 4-row decode step, and whisper's
# projections (q, k, v plain, wo with the residual), its un-gated MLP (w_up
# with the GELU, w_down with the residual) at a 4-row decode step and over
# the encoder's 1500 frames. Each with the chain the model runs there.
def _a8b_k1_cases():
    llava, whisper = get_config("llava-next-mistral-7b"), get_config("whisper-base")
    d, kv, f, n_img = llava.d_model, llava.n_kv * llava.head_dim_, llava.d_ff, llava.n_img_tokens
    cases = [(n_img, d, d, "gelu"), (n_img, d, d, "none"), (4, d, kv, "none"), (4, d, f, "none"),
             (4, d, f, "silu_mul")]
    dw, fw = whisper.d_model, whisper.d_ff
    for m in (4, whisper.enc_seq):
        cases += [(m, dw, dw, "none"), (m, dw, dw, "residual"), (m, dw, fw, "gelu"),
                  (m, fw, dw, "residual")]
    return cases


A8B_K1_CASES = _a8b_k1_cases()
A8B_CHAINS = {"none": (), "gelu": ("gelu",), "residual": ("residual",), "silu_mul": ("silu", "mul")}


@pytest.mark.parametrize("case", A8B_K1_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k1_at_llava_and_whispers_shapes_matches_plain(cuda_device, case):
    """Each case's chain on sm90, bitwise on repeat, within the plain
    version's gate."""
    k1 = _k1_module()
    m, k, n, chain = case
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert k1._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    steps = A8B_CHAINS[chain]
    operands = tuple(torch.randn((m, n), generator=gen, device=cuda_device).bfloat16()
                     for s in steps if s in ("residual", "mul"))
    before = dict(opope_gemm.launches_by_route)
    got = opope_gemm(a, b, epilogue=steps, epilogue_operands=operands)
    again = opope_gemm(a, b, epilogue=steps, epilogue_operands=operands)
    torch.cuda.synchronize()
    assert opope_gemm.launches_by_route == dict(before, sm90=before["sm90"] + 2)
    assert torch.equal(got, again)
    _check(got, a, b, None, torch.bfloat16, steps, operands)


# jamba-v0.1-52b and xlstm-125m (ROADMAP A.8c) at their published widths:
# K1 at every projection the recurrent mixers add (mamba's in_proj, x_proj
# with its N of dt_rank + 2 d_state = 288, dt_proj, out_proj; the mLSTM's and
# sLSTM's square and 4x projections and w_if with its N of 2 heads x 4 = 8)
# and jamba's 16-expert router, at a 4-row decode step and a 128-row
# prefill, no chain (the mixers' GEMMs carry none); K4 and K5 at jamba's
# expert GEMMs (G 16, 4096 <-> 14336) at a 4-row decode step's capacity
# (1), a 2 x 64 prefill's (20) and a 512-token group's (80).
def _a8c_k1_shapes():
    j, x = get_config("jamba-v0.1-52b"), get_config("xlstm-125m")
    d, di, rank = j.d_model, j.mamba.expand * j.d_model, -(-j.d_model // 16)
    pairs = {(d, 2 * di), (di, rank + 2 * j.mamba.d_state), (rank, di), (di, d),
             (d, j.moe.n_experts), (x.d_model, x.d_model), (x.d_model, 4 * x.d_model),
             (x.d_model, 2 * x.n_heads)}
    return [(m, k, n) for m in (4, 128) for k, n in sorted(pairs)]


A8C_K1_SHAPES = _a8c_k1_shapes()
JAMBA_EXPERT_SHAPES = [(16, m, k, n) for m in (1, 20, 80) for k, n in ((4096, 14336),
                                                                        (14336, 4096))]


def _expert_chains(down, up):
    """An expert GEMM's chains: w_up (bf16 out) and w_gate with silu·mul
    (bf16 out) going up; w_down in fp32 out, as the dispatch combines in
    fp32."""
    if down:
        return (((), (), torch.float32),)
    return (((), (), torch.bfloat16), (("silu", "mul"), (up,), torch.bfloat16))


@pytest.mark.parametrize("shape", A8C_K1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_at_jamba_and_xlstms_shapes_matches_plain(cuda_device, shape):
    """On the route K1's plan gives (sm90 at every one of these shapes: 2K
    and 2N bytes are multiples of 16), bitwise on repeat, within the plain
    version's gate."""
    k1 = _k1_module()
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    route = k1._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route
    assert route == "sm90"
    before = dict(opope_gemm.launches_by_route)
    got = opope_gemm(a, b)
    again = opope_gemm(a, b)
    torch.cuda.synchronize()
    assert opope_gemm.launches_by_route == dict(before, **{route: before[route] + 2})
    assert torch.equal(got, again)
    _check(got, a, b, None, torch.bfloat16, (), ())


@pytest.mark.parametrize("shape", JAMBA_EXPERT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k4_and_k5_at_jambas_expert_shapes_match_plain(cuda_device, shape):
    """Each expert GEMM's chain on K4 (bitwise on repeat, within the plain
    version's gate) and on K5 (bitwise against its plain version but the
    transcendental op), every launch on sm90."""
    q8 = _q8_module()
    g, m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(g + m + k + n)
    a = torch.randn((g, m, k), generator=gen, device=cuda_device).bfloat16()
    b = (torch.randn((g, k, n), generator=gen, device=cuda_device) * k ** -0.5).bfloat16()
    assert tg._plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr()).route == "sm90"
    aq, saq, bq, sbq = _q8_operands(gen, cuda_device, (g, m), k, n)
    assert _k5_route(aq, bq) == "sm90"
    up = torch.randn((g, m, n), generator=gen, device=cuda_device).bfloat16()
    k5 = q8.opope_gemm_q8_grouped
    for steps, operands, out_dtype in _expert_chains(k > n, up):
        before4, before5 = (dict(x.launches_by_route) for x in (tg.opope_gemm_grouped, k5))
        got = tg.opope_gemm_grouped(a, b, out_dtype=out_dtype, epilogue=steps,
                                    epilogue_operands=operands)
        again = tg.opope_gemm_grouped(a, b, out_dtype=out_dtype, epilogue=steps,
                                      epilogue_operands=operands)
        got5 = k5(aq, saq, bq, sbq, out_dtype=out_dtype, epilogue=steps, epilogue_operands=operands)
        torch.cuda.synchronize()
        assert tg.opope_gemm_grouped.launches_by_route == dict(before4, sm90=before4["sm90"] + 2)
        assert k5.launches_by_route == dict(before5, sm90=before5["sm90"] + 1)
        assert torch.equal(got, again)
        _check(got, a, b, None, out_dtype, steps, operands, plain=tg.opope_gemm_grouped_plain)
        want5 = q8.opope_gemm_q8_grouped_plain(aq, saq, bq, sbq, out_dtype=out_dtype,
                                               epilogue=steps, epilogue_operands=operands)
        _check_q8(got5, want5, steps[0] if steps else "none")


def test_jamba_and_xlstm_reduced_serve_on_the_kernels(cuda_device):
    """Reduced bf16 jamba (its mamba widths raised so every GEMM plans
    sm90) and xlstm through the continuous engine on the card: finite,
    in-vocabulary tokens, the K1 (and K4) launches of every forward."""
    for arch in ("jamba-v0.1-52b", "xlstm-125m"):
        cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="bfloat16",
                                  head_dim=32, d_model=get_config(arch).reduced().n_heads * 32)
        params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                 cuda_device)
        trace = poisson_trace(4, seed=0, vocab=cfg.vocab, prompt_lens=(8, 13), gen_lens=(3, 5))
        eng = ContinuousEngine(cfg=cfg, params=params, n_slots=2, max_len=32)
        opope_gemm.launches = tg.opope_gemm_grouped.launches = 0
        report = eng.serve(trace)
        forwards = report.decode_steps + report.prefill_batches
        per_k1 = sum({"mamba": 4, "mlstm": 6, "slstm": 2, "attn": 4}[bd.mixer]
                     + {"mlp": 3, "moe": 1, "none": 0}[bd.ffn] for bd in cfg.pattern)
        per_k4 = 3 * sum(bd.ffn == "moe" for bd in cfg.pattern)
        assert (opope_gemm.launches, tg.opope_gemm_grouped.launches) == (
            per_k1 * forwards, per_k4 * forwards)
        for r in trace:
            out = report.outputs[r.rid]
            assert len(out) == r.max_new_tokens and all(0 <= t < cfg.vocab for t in out)


# Every dtype the reference's kernels take (the dtype rule of
# kernels/opope_gemm.py): K1 and K4 on every pair of fp32, bf16, fp16, e4m3
# and e5m2, K3 in each at any head dim, K6 on fp16 and the 8-bit floats.
# Integer-valued inputs make every fp32 sum exact, whatever its order, so
# those cases are held bit for bit against the plain versions, NaNs
# included; random ones at the tolerances above.
FLOATS = [torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2]
FLOAT_IDS = ["fp32", "bf16", "fp16", "e4m3", "e5m2"]
DTYPE_SHAPES = [(5, 40, 24), (130, 136, 264), (64, 256, 128)]


def _ints(gen, shape, dtype, device):
    """Integers in [-3, 3]: exact in every one of FLOATS."""
    return torch.randint(-3, 4, shape, generator=gen, device=device).to(dtype)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8))


def _k1_route(a, b):
    k1 = _k1_module()
    m, k = a.shape[-2:]
    n = b.shape[-1]
    return k1._plan(m, n, k, k1.plan_dtype(a.dtype, b.dtype), a.data_ptr(), b.data_ptr()).route


@pytest.mark.parametrize("b_dtype", FLOATS, ids=FLOAT_IDS)
@pytest.mark.parametrize("a_dtype", FLOATS, ids=FLOAT_IDS)
def test_k1_and_k4_take_every_dtype_pair(cuda_device, a_dtype, b_dtype):
    """Each pair launches on its route (sm90 for two bf16 or two fp16
    operands, tile otherwise), out in A's dtype by default: integer-valued
    calls bitwise against the plain version, random ones in fp32 at
    _check's tolerance."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for m, k, n in DTYPE_SHAPES:
        for lead, kern, plain in (((), opope_gemm, opope_gemm_plain),
                                  ((3,), tg.opope_gemm_grouped, tg.opope_gemm_grouped_plain)):
            a = _ints(gen, lead + (m, k), a_dtype, cuda_device)
            b = _ints(gen, lead + (k, n), b_dtype, cuda_device)
            route = (_k1_route(a[0], b[0]) if lead else _k1_route(a, b))
            assert route == ("sm90" if a_dtype == b_dtype and a_dtype in (torch.bfloat16,
                                                                          torch.float16)
                             else "tile")
            before = dict(kern.launches_by_route)
            got = kern(a, b)
            torch.cuda.synchronize()
            assert kern.launches_by_route == dict(before, **{route: before[route] + 1})
            _same_bits(got, plain(a, b))
            _same_bits(kern(a, b, out_dtype=torch.float32), plain(a, b, out_dtype=torch.float32))
            x = torch.randn(lead + (m, k), generator=gen, device=cuda_device).to(a_dtype)
            y = (torch.randn(lead + (k, n), generator=gen, device=cuda_device)
                 * k ** -0.5).to(b_dtype)
            _check(kern(x, y, out_dtype=torch.float32), x, y, None, torch.float32, (), (),
                   plain=plain)


@pytest.mark.parametrize("dtype", FLOATS, ids=FLOAT_IDS)
def test_k1_and_k4_take_c_and_epilogue_operands_of_every_dtype(cuda_device, dtype):
    """C and a two-step chain's row operand in each dtype, on e4m3 and fp16
    operands (tile and sm90 routes), bit for bit on integer values."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    m, k, n = 65, 200, 136
    for in_dtype in (torch.float8_e4m3fn, torch.float16):
        for lead, kern, plain in (((), opope_gemm, opope_gemm_plain),
                                  ((2,), tg.opope_gemm_grouped, tg.opope_gemm_grouped_plain)):
            a = _ints(gen, lead + (m, k), in_dtype, cuda_device)
            b = _ints(gen, lead + (k, n), in_dtype, cuda_device)
            c = _ints(gen, lead + (m, n), dtype, cuda_device)
            row = _ints(gen, (lead[0], 1, n) if lead else (1, n), dtype, cuda_device)
            for out_dtype in (torch.float32, torch.float16):
                got = kern(a, b, c, out_dtype=out_dtype)
                _same_bits(got, plain(a, b, c, out_dtype=out_dtype))
                kw = dict(out_dtype=out_dtype, epilogue=("relu", "scale"), epilogue_operands=(row,))
                _same_bits(kern(a, b, **kw), plain(a, b, **kw))


def test_e4m3_out_overflows_to_nan_bit_for_bit(cuda_device):
    """Sums of 448, 464 (the tie, rounding down), 468 and 512 written as
    e4m3 on both routes' dtype classes: 448, 448, NaN, NaN, as ml_dtypes
    casts them (torch's own cast would saturate to 448)."""
    a = torch.zeros((4, 128), device=cuda_device)
    for i, count in enumerate((112, 116, 117, 128)):
        a[i, :count] = 4.0
    for b_dtype in (torch.float8_e4m3fn, torch.bfloat16):
        x, y = a.to(torch.float8_e4m3fn), torch.ones((128, 64), device=cuda_device).to(b_dtype)
        got = opope_gemm(x, y)
        want = opope_gemm_plain(x, y)
        _same_bits(got, want)
        vals = got.float()[:, 0].tolist()
        assert vals[:2] == [448.0, 448.0] and all(v != v for v in vals[2:])
        grouped = tg.opope_gemm_grouped(x[None], y[None])
        _same_bits(grouped, tg.opope_gemm_grouped_plain(x[None], y[None]))


def _attn_close_any(got, want):
    """_attn_close for fp32, bf16 and fp16; the 8-bit floats (P rounds to
    v's format where the reference rounds it on both sides) at
    chip_smoke's gate: within one ulp of the output format plus one at the
    largest magnitude, and an error RMS within a sixteenth of the format's
    relative spacing times the plain output's RMS."""
    if got.dtype not in (torch.float8_e4m3fn, torch.float8_e5m2):
        _attn_close(got, want)
        return
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all() and torch.isfinite(w).all()
    mant = 4 if got.dtype == torch.float8_e4m3fn else 3
    emin = -6 if got.dtype == torch.float8_e4m3fn else -14

    def ulp(x):
        _, e = torch.frexp(x)
        return torch.ldexp(torch.ones_like(x), e.clamp(min=emin + 1) - mant)

    assert ((g - w).abs() <= ulp(w) + ulp(w.abs().max())).all()
    spacing = 2.0 ** (1 - mant)
    assert (g - w).square().mean().sqrt() <= spacing / 16 * w.square().mean().sqrt()


@pytest.mark.parametrize("d", [8, 16, 80, 256, 320])
@pytest.mark.parametrize("dtype", FLOATS, ids=FLOAT_IDS)
def test_attention_takes_every_dtype_and_head_dim(cuda_device, dtype, d):
    k3 = _k3_module()
    for b, h, s, t, causal in ((1, 2, 96, 160, True), (2, 1, 70, 70, False), (1, 1, 1, 300, True)):
        gen = torch.Generator(device=cuda_device).manual_seed(d + s)
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda_device).to(dtype)
                   for n in (s, t, t))
        route = _k3_route(q, k, v, causal)
        assert route == ("sm90" if dtype == torch.bfloat16 and d in (64, 128) else "tile")
        before = dict(k3.opope_attention.launches_by_route)
        got = opope_attention_bhsd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert k3.opope_attention.launches_by_route == dict(before, **{route: before[route] + 1})
        assert got.dtype == dtype and got.shape == q.shape
        _attn_close_any(got, opope_attention_plain(q, k, v, causal=causal))
        # A strided view (every other row of a wider tensor) reads in place.
        wide = torch.randn((b, h, 2 * t, d + 8), generator=gen, device=cuda_device).to(dtype)
        kv = wide[:, :, ::2, :d]
        _attn_close_any(opope_attention_bhsd(q, kv, kv, causal=causal),
                        opope_attention_plain(q, kv, kv, causal=causal))


@pytest.mark.parametrize("block_k", [32, 64, 100, 128, 300])
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2], ids=["e4m3", "e5m2"])
def test_fp8_attention_rounds_p_at_the_references_panels(cuda_device, dtype, block_k):
    """8-bit v: P rounds at the running maximum through each of the
    reference's KV panels of ``block_k`` keys: panels of 32 (two in each of
    the kernel's 64-key panels), of 64 (the kernel's own), of 100 (which
    the kernel's straddle), of 128 and of all 300 keys (each several of the
    kernel's); causal and not, rows without a valid key (S > T) included."""
    for s, t, causal in ((96, 300, True), (40, 300, False), (320, 300, True), (1, 300, True)):
        gen = torch.Generator(device=cuda_device).manual_seed(block_k + s)
        q, k, v = (torch.randn((1, 2, n, 80), generator=gen, device=cuda_device).to(dtype)
                   for n in (s, t, t))
        kw = dict(causal=causal, block_q=64, block_k=block_k)
        _attn_close_any(opope_attention_bhsd(q, k, v, **kw), opope_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("dtypes", [(torch.float16, torch.float16),
                                    (torch.float8_e4m3fn, torch.float8_e4m3fn),
                                    (torch.float8_e5m2, torch.float8_e5m2),
                                    (torch.float32, torch.float8_e4m3fn),
                                    (torch.float16, torch.float8_e5m2)],
                         ids=["fp16", "e4m3", "e5m2", "fp32-e4m3", "fp16-e5m2"])
def test_scan_takes_fp16_and_fp8_bitwise(cuda_device, dtypes):
    for s, d in SCAN_SHAPES:
        gen = torch.Generator(device=cuda_device).manual_seed(s + d)
        decay = (0.2 + 0.79 * torch.rand((s, d), generator=gen, device=cuda_device)).to(dtypes[0])
        update = torch.randn((s, d), generator=gen, device=cuda_device).to(dtypes[1])
        before = tscan.opope_chunked_scan.launches
        got = tscan.opope_chunked_scan(decay, update)
        torch.cuda.synchronize()
        assert tscan.opope_chunked_scan.launches == before + 1
        assert torch.equal(got, tscan.opope_chunked_scan_plain(decay, update))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_reduced_fp16_models_serve_on_the_sm90_routes(cuda_device, arch):
    """A reduced fp16 model: prefill logits on the kernels against the
    plain backend, and the continuous engine (K/V in bf16) with every K4
    launch and every K1 launch on sm90 but the reduced router's (N = 4
    experts: 8-byte rows, which TMA does not take; at full width 64)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float16")
    params = api.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    tokens = tokens.to(cuda_device)
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 32, backend="torch")
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 32)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    trace = poisson_trace(6, seed=1, vocab=cfg.vocab, prompt_lens=(5, 12, 20),
                          gen_lens=(3, 7), mean_interarrival=1.0)
    for kern in (opope_gemm, tg.opope_gemm_grouped):
        kern.launches = 0
        kern.launches_by_route.update(sm90=0, tile=0)
    report = ContinuousEngine(cfg=cfg, params=params, n_slots=2, max_len=32).serve(trace)
    routers = 0 if cfg.moe is None else cfg.n_layers * (report.decode_steps
                                                        + report.prefill_batches)
    assert opope_gemm.launches_by_route == {"sm90": opope_gemm.launches - routers,
                                            "tile": routers}
    k4 = tg.opope_gemm_grouped
    assert k4.launches_by_route == {"sm90": k4.launches, "tile": 0}
    assert opope_gemm.launches > routers and (cfg.moe is None or k4.launches > 0)
    assert all(len(report.outputs[r.rid]) == r.max_new_tokens for r in trace)
