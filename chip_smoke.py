#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, started together);
3. the O-POPE GEMM kernel (K1) against its plain PyTorch version on the
   card, at both models' K1 shapes and chains for M = 4, 64, 256 and 512
   (the sm90 route, and bitwise equal on repeat), timed at chatglm3-6b's
   on the sm90 route, on the tile route and beside ``torch.matmul`` and
   the card's bound, and at small ragged shapes on both routes for every
   epilogue op;
4. full-width chatglm3-6b (28 layers, bf16, random weights from seed 0):
   (a) prefill logits through the kernel against the plain backend,
   (b) the continuous-batching engine on a Poisson trace — the first main
       path, whose kernel launches are counted, every one on K1's sm90
       route — (c) the lockstep engine, and (d) a lockstep decode step's
       wall time beside its K1 device time;
5. the grouped O-POPE GEMM kernel (K4) against its plain version on the
   card, at deepseek-moe-16b's expert shapes and chains for M = 1, 30 and 60
   (required on the sm90 route and checked on the tile route too; timed by
   device time on both routes beside ``torch.bmm`` and the card's bound)
   and at small ragged shapes for every epilogue op and C form (on the tile
   route, and aligned ones on both routes);
6. full-width deepseek-moe-16b (28 layers, bf16, random weights from seed 0),
   after chatglm3-6b's weights are freed:
   (a) routing in a full prefill on the kernels against the plain router on
       the same layer inputs, the drift of two free-running prefills beside
       that of two valid summation orders, and one MoE layer on both
       backends with the same routing,
   (b) the continuous-batching engine on a Poisson trace — the second main
       path, whose K1 and K4 launches are counted, every one on its sm90
       route — and the lockstep engine,
   (c) a lockstep decode step's wall time beside its K1 and K4 device time;
7. the int8 GEMM kernels K2 and K5 against their plain versions on the card,
   bitwise where the chain has no transcendental op, at the shapes of both
   models' quantized GEMMs (every K2 and K5 shape required on its sm90 route
   and checked on the tile route too, a split-K call bitwise on repeat; both
   timed by device time on both routes, K2 at the decode and the prefill M
   beside ``torch._int_mm`` + dequant, K5 at capacities 1, 30 and 60 beside
   K4's sm90 route on the same shapes in bf16 and the card's bound; both beside one per-call weight
   quantization) and at small ragged shapes on the tile route and aligned
   ones on the sm90 route (K5 at G = 3 and 64), each route required to have
   run; ptxas must report no spill for K5's kernels;
8. full-width chatglm3-6b under ``mlp_q8_policy()`` (run after phase 4, on its
   weights) and full-width deepseek-moe-16b under
   ``PrecisionPolicy(rules={"moe": "q8"})`` (after phase 6): (a) one layer on
   the kernels against the plain backends, (b) the all-layer prefill logits
   against a floor this run measures, (c) the q8-vs-bf16 logit difference,
   (d) the quantized main path — a 4 x 64-token prefill and 16 greedy decode
   steps through ``api.prefill``/``api.decode`` with exact launch counts,
   every K1, K2 and K5 launch required on the sm90 route —
   and (e) a decode step's wall and device time and its kernel split, each
   kernel booked by its own name, none that the path launched at zero;
9. after deepseek-moe-16b's weights are freed, the ``kernels`` entry points
   of K3 and K6: (a) ``opope_attention_bhsd`` at chatglm3-6b's attention
   width (32 heads of 128, its 2 KV heads expanded) at a 4 x 2048 causal
   prefill, a 512-row continuation over 2048 keys, a decode row and a
   non-causal call, and ``opope_chunked_scan`` at jamba-v0.1's mamba scan
   width (8192 x 16 columns, 4096 steps) — the slice's main path, its
   launches counted, every K3 launch required on the sm90 route — each
   against its plain version (K6 bitwise); K3 timed by device time (CUDA
   events around calls queued behind a sleeping kernel) on its planned
   route and on the tile route, beside SDPA and the bound, and
   checked on both routes at ragged fp32/bf16 cases and sm90 panel edges,
   plus chatglm3-6b's prefill_32k sequence (both routes and SDPA only);
   (b) the prefill against the model's own ``blockwise_attention``.

The last lines are a JSON ``{"kernels": [...]}`` record and then
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and no result is printed. Without a CUDA device, or outside a checkout,
it exits with code 2.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
L2_BYTES = 50 * 2**20
# Free-running full-prefill routing, kernels vs plain: at least the share
# two plain summation orders (fp32, fp64) agree on in the same run, less
# this margin, and never below the absolute floor.
FREE_ROUTING_MARGIN = 0.02
FREE_ROUTING_FLOOR = 0.9
# All-layer prefill logits under a q8 policy, kernels vs plain: their RMS
# difference at most this many times that of two plain summation orders
# (fp32, fp64) in the same run. An int8 value that rounds the other way
# after a 1-ulp difference upstream moves the logits by one quantization
# step in both comparisons alike.
Q8_LOGIT_FLOOR_FACTOR = 3.0


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(torch, fn, n_bufs: int, iters: int = 0, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` by CUDA events; ``i`` cycles over
    ``n_bufs`` operand copies so weights come from device memory, not L2."""
    iters = iters or max(10, n_bufs)
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` by CUDA events around ``iters`` calls
    that the host queues behind a sleeping kernel: the device runs them back
    to back once it wakes, so the events time the device's work and not the
    host's issue rate, with no profiler. The start event must still be
    pending when the last call is queued; else the sleep was too short and
    it is taken again, four times longer. Phases 3, 5, 7 and 9 time K1, K4,
    K2 and K3 this way: torch.profiler returned traces missing kernel
    events, late in a run and once in phase 3."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000  # ~25 ms at the H100's clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / iters
        torch.cuda.synchronize()
        cycles *= 4
    raise AssertionError("the host did not queue the timed calls within the device's sleep")


def ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at the magnitude of ``x``."""
    mant = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}[dtype]
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - mant)


def check_close(torch, out, plain, out_dtype, what):
    """Kernel output against the plain version on the same inputs
    (``plain(out_dtype)`` computes it): fp32 within rtol 1e-4 / atol 1e-3
    (only the order of sums differs); bf16/fp16 within one ulp of the plain
    fp32 result, plus 1e-5 of its largest magnitude for sum-order noise where
    the result nearly cancels; int8 within 1 (a rounding boundary may fall
    between two sum orders). Returns the largest absolute difference."""
    if out_dtype == torch.int8:
        ref = plain(torch.int8)
        err = (out.int() - ref.int()).abs().max().item() if out.numel() else 0
        if err > 1:
            raise AssertionError(f"{what}: int8 off by {err}")
        return float(err)
    ref = plain(torch.float32)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - ref).abs()
    err = diff.max().item() if out.numel() else 0.0
    if out_dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3, msg=what)
    else:
        tol = ulp(torch, ref, out_dtype) + 1e-5 * ref.abs().max()
        bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"{what}: {bad} elements beyond 1 ulp (max err {err})")
    return err


def check_routes(kern, launches, what, name="K1"):
    """Every launch of ``kern`` (K1, or K2, K4 or K5 with ``name``) counted
    since the reset went through the sm90 route."""
    if kern.launches_by_route != {"sm90": launches, "tile": 0}:
        raise AssertionError(f"{what}: {name} launches by route {kern.launches_by_route}, "
                             f"want all {launches} on sm90")


def k1_plain(a, b, c, steps, ops_):
    """K1's plain version on these inputs, as a function of the out dtype."""
    from repro_torch.kernels.opope_gemm import opope_gemm_plain

    return lambda out_dtype: opope_gemm_plain(
        a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)


def gemm_bound(m, k, n, n_full_operands, elem=2):
    """Least time in ms of one GEMM on the card, and what bounds it: A, B
    and the output moved once each plus the epilogue's full operands, or
    2MNK at the bf16 tensor-core rate."""
    nbytes = elem * (m * k + k * n + m * n * (1 + n_full_operands))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


K1_MS = (4, 64, 256, 512)  # rows of K1's checked and timed calls: decode slots to prefill


def kernel_phase(torch, ep, cfg, mcfg, dev):
    """Phase 3. Returns the layer's GEMMs, the per-shape timing rows and the
    largest error."""
    import importlib

    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    k1mod = importlib.import_module("repro_torch.kernels.opope_gemm")

    gen = torch.Generator(device=dev).manual_seed(0)
    chains = {"none": (), "residual": ("residual",), "silu+mul": ("silu", "mul")}

    def operands(m, n, chain, dtype):
        """The chain's steps and its one full operand (none for "none")."""
        steps = chains[chain]
        if not steps:
            return steps, ()
        return steps, (torch.randn((m, n), generator=gen, device=dev).to(dtype),)

    d, dq, dkv, dff = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_, cfg.d_ff
    # The 7 GEMMs of one layer: (name, K, N, chain).
    layer = [("wq", d, dq, "none"), ("wk", d, dkv, "none"), ("wv", d, dkv, "none"),
             ("wo", dq, d, "residual"), ("w_up", d, dff, "none"),
             ("w_gate", d, dff, "silu+mul"), ("w_down", dff, d, "residual")]
    # deepseek-moe-16b's K1 GEMMs: attention, router, shared experts.
    md, mdq, msh = mcfg.d_model, mcfg.n_heads * mcfg.head_dim_, mcfg.moe.d_ff_shared
    k1_shapes = {(k, n) for _, k, n, _ in layer} | {
        (md, mdq), (mdq, md), (md, mcfg.moe.n_experts), (md, msh), (msh, md)}
    max_err = 0.0
    # Correctness at both models' K1 shapes, every chain they use, on the
    # route the plan gives them (every one the sm90 route).
    for m in K1_MS:
        for kk, n in sorted(k1_shapes):
            a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
            b = (torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
            plan = k1mod._plan(m, n, kk, a.dtype, a.data_ptr(), b.data_ptr())
            if plan.route != "sm90":
                raise AssertionError(f"main-path shape M={m} K={kk} N={n} planned {plan}")
            for chain in chains:
                steps, ops_ = operands(m, n, chain, torch.bfloat16)
                out = opope_gemm(a, b, None, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                err = check_close(torch, out, k1_plain(a, b, None, steps, ops_),
                                  torch.bfloat16, f"main M={m} K={kk} N={n} {chain}")
                max_err = max(max_err, err)
            log(f"check main-path M={m} K={kk} N={n} (config {plan.config}, splits "
                f"{plan.splits}), chains {list(chains)}: max_abs_err={max_err:.3g} ok")
        # Determinism: a split-K call twice, bitwise.
        a = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((d, d), generator=gen, device=dev).to(torch.bfloat16)
        if not torch.equal(opope_gemm(a, b), opope_gemm(a, b)):
            raise AssertionError(f"M={m} K={d} N={d}: two calls differ")

    # Timing at the main path's (shape, chain) pairs, weights cold in L2:
    # the planned (sm90) route, the tile route on the same call, the plain
    # version and torch.matmul.
    rows = []
    # deepseek-moe-16b's K1 GEMMs of one layer (attention, router, shared
    # experts), at its decode width only.
    ds_layer = {(md, mdq, "none"), (mdq, md, "residual"), (md, mcfg.moe.n_experts, "none"),
                (md, msh, "none"), (md, msh, "silu+mul"), (msh, md, "residual")}
    timed = [(cfg.name, m, k, n, ch) for m in K1_MS
             for k, n, ch in sorted({(k, n, ch) for _, k, n, ch in layer})]
    timed += [(mcfg.name, 4, k, n, ch) for k, n, ch in sorted(ds_layer)]
    for model, m, kk, n, chain in timed:
        steps, ops_ = operands(m, n, chain, torch.bfloat16)
        b_bytes = kk * n * 2
        n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / b_bytes)))
        a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
        bs = [(torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
              for _ in range(n_bufs)]
        plan = k1mod._plan(m, n, kk, a.dtype, a.data_ptr(), bs[0].data_ptr())

        def sm90(i):
            return opope_gemm(a, bs[i], None, epilogue=steps, epilogue_operands=ops_)

        iters = max(20, n_bufs)
        ms = queued_ms(torch, lambda i: sm90(i % n_bufs), iters)
        event_ms = time_ms(torch, sm90, n_bufs)
        tile_ms = queued_ms(torch, lambda i: k1mod._run(
            a, bs[i % n_bufs], None, None, steps, ops_, route="tile"), iters)
        plain_ms = time_ms(torch, lambda i: opope_gemm_plain(
            a, bs[i], None, epilogue=steps, epilogue_operands=ops_), n_bufs)
        lib_ms = queued_ms(torch, lambda i: torch.matmul(a, bs[i % n_bufs]), iters)
        bound_ms, bound_by = gemm_bound(m, kk, n, len(ops_))
        out = opope_gemm(a, bs[0], None, epilogue=steps, epilogue_operands=ops_)
        err = check_close(torch, out, k1_plain(a, bs[0], None, steps, ops_),
                          torch.bfloat16, f"timed M={m} K={kk} N={n} {chain}")
        out = k1mod._run(a, bs[0], None, None, steps, ops_, route="tile")
        check_close(torch, out, k1_plain(a, bs[0], None, steps, ops_),
                    torch.bfloat16, f"timed tile route M={m} K={kk} N={n} {chain}")
        max_err = max(max_err, err)
        row = {"model": model, "m": m, "k": kk, "n": n, "epilogue": chain, "route": plan.route,
               "config": plan.config, "splits": plan.splits, "ms": ms,
               "event_ms": event_ms, "tile_ms": tile_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err}
        rows.append(row)
        log(f"time {model} M={m} K={kk} N={n} chain={chain}: sm90 {ms:.4f} ms device (config "
            f"{plan.config}, splits {plan.splits}; {event_ms:.4f} ms a call by CUDA events, "
            f"host issue included), tile route {tile_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms "
            f"(device), plain {plain_ms:.4f} ms (events), bound {bound_ms:.4f} ms "
            f"({bound_by}), max_abs_err {err:.3g}")
    del bs

    # Coverage: ragged shapes, fp32 and bf16 in, both C forms, every op.
    n_cov = 0
    k1mod.opope_gemm.launches_by_route.update(sm90=0, tile=0)
    for m, kk, n in ((5, 40, 24), (130, 300, 200), (64, 128, 192), (1, 264, 136),
                     (63, 1032, 72), (65, 520, 200), (130, 136, 264)):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn((m, kk), generator=gen, device=dev).to(dt)
            b = torch.randn((kk, n), generator=gen, device=dev).to(dt)
            cs = {"none": None,
                  "row": torch.randn((n,), generator=gen, device=dev).to(dt),
                  "full": torch.randn((m, n), generator=gen, device=dev).to(dt)}
            row_op = torch.randn((1, n), generator=gen, device=dev)
            full_op = torch.randn((m, n), generator=gen, device=dev).to(dt)
            for c_name, c in cs.items():
                acc_max = opope_gemm_plain(a, b, c, out_dtype=torch.float32).abs().max()
                scalar = (acc_max / 100.0).reshape(1, 1)
                for name in ep.epilogue_ops():
                    kind = ep.op_kind(name)
                    ops_ = {"none": (), "row": (row_op,), "full": (full_op,),
                            "scalar": (scalar,)}[kind]
                    out_dtype = torch.int8 if name == "requant_int8" else dt
                    out = opope_gemm(a, b, c, out_dtype=out_dtype, epilogue=(name,),
                                          epilogue_operands=ops_)
                    sync(torch, dev)
                    check_close(torch, out, k1_plain(a, b, c, (name,), ops_), out_dtype,
                                f"coverage {m}x{kk}x{n} {dt} C={c_name} {name}")
                    n_cov += 1
            # One long chain, fp16 out, and the requant chain into int8.
            chain = ("gelu", "scale", "residual", "mul", "relu", "bias")
            ops_ = (row_op, full_op, full_op, row_op)
            for out_dtype in (torch.float16, dt):
                out = opope_gemm(a, b, cs["row"], out_dtype=out_dtype, epilogue=chain,
                                      epilogue_operands=ops_)
                sync(torch, dev)
                check_close(torch, out, k1_plain(a, b, cs["row"], chain, ops_), out_dtype,
                            f"coverage chain {m}x{kk}x{n} {dt} -> {out_dtype}")
                n_cov += 1
            chain = ("silu", "mul", "requant_int8")
            acc_max = opope_gemm_plain(a, b, out_dtype=torch.float32).abs().max()
            ops_ = (full_op, (acc_max / 50.0).reshape(1, 1))
            out = opope_gemm(a, b, out_dtype=torch.int8, epilogue=chain,
                                  epilogue_operands=ops_)
            sync(torch, dev)
            check_close(torch, out, k1_plain(a, b, None, chain, ops_), torch.int8,
                        f"coverage requant chain {m}x{kk}x{n} {dt}")
            n_cov += 1
    log(f"coverage: {n_cov} ragged/dtype/C/epilogue cases within tolerance, launches by "
        f"route {opope_gemm.launches_by_route}")
    return layer, rows, max_err


def model_phase(torch, np, cfg, ops, dev):
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, ServeEngine, poisson_trace

    per_forward = 7 * cfg.n_layers
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {cfg.name}: {n_params / 1e9:.3f} B params on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # (a) prefill through the kernel against the plain backend.
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="torch")
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="cuda")
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("prefill logits not finite")
    if tuple(got.shape) != (2, cfg.vocab):
        raise AssertionError(f"prefill logits shape {tuple(got.shape)}")
    delta, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if delta > 2e-2 * scale:
        raise AssertionError(f"prefill logits: max|delta| {delta} > 2e-2 * {scale}")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"(a) prefill 2x64: max|dlogits| {delta:.4g} <= 2e-2 * max|logits| {scale:.4g}; "
        f"argmax agreement {agree:.2f}")

    # (b) the main path: continuous batching over a Poisson trace.
    eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    ops.reset_counts()
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    report = eng.timed_serve(trace)
    launches = opope_gemm.launches
    want = per_forward * (report.decode_steps + report.prefill_batches)
    if launches != want or ops.backend("torch").calls != 0:
        raise AssertionError(f"kernel launches {launches} != {want} (torch calls "
                             f"{ops.backend('torch').calls})")
    check_routes(opope_gemm, launches, "4(b)")
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {r.rid}: bad output {out}")
    log(f"(b) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, "
        f"mean_occupancy {report.mean_occupancy:.3f}, wall {report.wall_time_s:.3f} s, "
        f"{report.tokens_per_sec:.1f} tokens/s, TTFT p50 {report.ttft_p50 * 1e3:.1f} ms, "
        f"ITL p50 {report.itl_p50 * 1e3:.1f} ms, kernel launches {launches} "
        f"= 7 * {cfg.n_layers} * ({report.decode_steps} + {report.prefill_batches}), "
        f"all on the sm90 route")

    # (c) the lockstep engine.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    toks = ServeEngine(cfg=cfg, params=params, max_len=80).generate({"tokens": prompts}, 16)
    toks_host = toks.cpu()
    dt = time.perf_counter() - t0
    if tuple(toks_host.shape) != (4, 16) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"static engine output {tuple(toks_host.shape)}")
    if opope_gemm.launches != per_forward * 16:
        raise AssertionError(f"static launches {opope_gemm.launches} != {per_forward * 16}")
    check_routes(opope_gemm, opope_gemm.launches, "4(c)")
    log(f"(c) static: 4 x 64-token prompts, 16 tokens each in {dt:.3f} s "
        f"({64 / dt:.1f} tokens/s), kernel launches {opope_gemm.launches}")

    # (d) one lockstep decode step at 4 rows: host wall time per step.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i)
        sync(torch, dev)
        n_steps = 16
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = None
        if dev.type == "cuda":
            prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 83 + i),
                                  step_ms)
    dev_ms = None
    if prof is not None:
        bound = sum(1e3 * t.numel() * t.element_size() / HBM_BYTES_PER_S
                    for t in _leaves(params["blocks"]) if t.ndim >= 2)
        dev_ms = {"k1": sum(ms for key, ms, _ in prof if "opope_gemm_kernel" in key),
                  "busy": sum(ms for _, ms, _ in prof), "k1_byte_bound": bound}
        log(f"(d) decode step, 4 rows: {step_ms:.3f} ms wall; device busy {dev_ms['busy']:.3f} ms, "
            f"K1 {dev_ms['k1']:.3f} ms ({per_forward} launches, byte bound {bound:.3f} ms)")
    return {"continuous": report, "launches": launches, "decode_step_ms": step_ms,
            "device_ms": dev_ms, "params": params}


def k4_plain(k4, a, b, c, steps, ops_):
    """K4's plain version on these inputs, as a function of the out dtype."""
    return lambda out_dtype: k4.opope_gemm_grouped_plain(
        a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)


def grouped_phase(torch, k4, ops, ep, cfg, dev):
    """Phase 5. Returns the expert FFN's 3 grouped GEMMs, the per-shape
    timing rows, the largest error and the coverage launches by route."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    g, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    tile = functools.partial(k4._run, route="tile")
    # The 3 grouped GEMMs of one MoE layer: (name, K, N, chain, out dtype).
    ffn = [("w_up", d, f, "none", bf16), ("w_gate", d, f, "silu+mul", bf16),
           ("w_down", f, d, "none", f32)]
    rows, max_err = [], 0.0
    # M = the expert capacity: a 4-slot decode step (1), and a prefill of
    # 4 x 64 (30) and 4 x 128 (60) prompt tokens.
    for m in (1, 30, 60):
        for name, kk, n, chain, out_dtype in ffn:
            a = torch.randn((g, m, kk), generator=gen, device=dev).to(bf16)
            b = (torch.randn((g, kk, n), generator=gen, device=dev) * kk ** -0.5).to(bf16)
            steps, ops_ = (), ()
            if chain == "silu+mul":
                steps = ("silu", "mul")
                ops_ = (torch.randn((g, m, n), generator=gen, device=dev).to(bf16),)
            plan = k4._plan(m, n, kk, bf16, a.data_ptr(), b.data_ptr())
            if plan.route != "sm90":
                raise AssertionError(f"grouped {name} M={m}: planned on {plan.route}, want sm90")
            what = f"grouped G={g} M={m} K={kk} N={n} {chain}"
            plain = k4_plain(k4, a, b, None, steps, ops_)
            err = 0.0
            for route, fn in (("sm90", k4.opope_gemm_grouped), ("tile", tile)):
                out = fn(a, b, None, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                err = max(err, check_close(torch, out, plain, out_dtype, f"{what} on {route}"))
            max_err = max(max_err, err)
            # One call reads all G experts' weights (>= 184 MB, several
            # times the 50 MB L2), so each call finds them cold. Both
            # routes and torch.bmm by device time: CUDA events around calls
            # queued behind a sleeping kernel (queued_ms); the plain version
            # by CUDA events around a loop.
            ms = queued_ms(torch, lambda i: k4.opope_gemm_grouped(
                a, b, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_))
            tile_ms = queued_ms(torch, lambda i: tile(
                a, b, None, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_))
            plain_ms = time_ms(torch, lambda i: k4.opope_gemm_grouped_plain(
                a, b, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_), 1)
            lib_ms = queued_ms(torch, lambda i: torch.bmm(a, b))
            out_elem = 4 if out_dtype == f32 else 2
            nbytes = 2 * g * (m * kk + kk * n + m * n * len(ops_)) + out_elem * g * m * n
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * g * m * n * kk / BF16_FLOPS
            row = {"g": g, "m": m, "k": kk, "n": n, "name": name, "epilogue": chain,
                   "out_dtype": str(out_dtype).replace("torch.", ""), "route": plan.route,
                   "tile_rows": plan.bm, "ms": ms, "tile_ms": tile_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "max_abs_err": err}
            rows.append(row)
            log(f"grouped G={g} M={m} K={kk} N={n} {name} chain={chain} -> {row['out_dtype']}: "
                f"sm90 {ms:.4f} ms, tile route {tile_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"max_abs_err {err:.3g} (both routes)")
            del a, b, ops_, out

    # Coverage: G = 3, fp32 and bf16 in, every C form and op, through
    # grouped_matmul on the kernel against it on the plain version: ragged
    # shapes TMA cannot describe (tile route), and aligned ragged ones (M 1,
    # 5 and 65, K tails of 200 and 264, N of 24, 136 and 200) on both routes.
    n_cov, gc_ = 0, 3
    cuda_be = ops.backend("cuda")
    cov_routes = {"sm90": 0, "tile": 0}
    for m, kk, n in ((5, 40, 24), (130, 300, 200), (1, 200, 136), (65, 264, 200)):
        for dt in (f32, bf16):
            a = torch.randn((gc_, m, kk), generator=gen, device=dev).to(dt)
            b = torch.randn((gc_, kk, n), generator=gen, device=dev).to(dt)
            route = k4._plan(m, n, kk, dt, a.data_ptr(), b.data_ptr()).route
            routes = ("sm90", "tile") if route == "sm90" else ("tile",)
            cs = {"none": None,
                  "row": torch.randn((gc_, n), generator=gen, device=dev).to(dt),
                  "full": torch.randn((gc_, m, n), generator=gen, device=dev).to(dt)}
            rows_ = {"[N]": torch.randn((n,), generator=gen, device=dev),
                     "[G,N]": torch.randn((gc_, n), generator=gen, device=dev)}
            full_op = torch.randn((gc_, m, n), generator=gen, device=dev).to(dt)
            acc_max = k4.opope_gemm_grouped_plain(a, b, out_dtype=f32).abs().max()
            for c_name, c in cs.items():
                for name in ep.epilogue_ops():
                    kind = ep.op_kind(name)
                    specs = {"none": {"": name},
                             "row": {r: (name, x) for r, x in rows_.items()},
                             "full": {"": (name, full_op)},
                             "scalar": {"": (name, acc_max / 100.0)}}[kind]
                    for form, spec in specs.items():
                        out_dtypes = (torch.int8,) if name == "requant_int8" else (dt, f32)
                        for out_dtype, rt in itertools.product(out_dtypes, routes):
                            def run(be, od, c=c, spec=spec):
                                return ops.grouped_matmul(a, b, c, backend=be, out_dtype=od,
                                                          epilogue=[spec])
                            with _patched(cuda_be, "grouped_fn",
                                          functools.partial(k4._run, route=rt)):
                                out = run("cuda", out_dtype)
                            sync(torch, dev)
                            check_close(torch, out, lambda od: run("torch", od), out_dtype,
                                        f"grouped coverage {gc_}x{m}x{kk}x{n} {dt} C={c_name} "
                                        f"{name}{form} -> {out_dtype} on {rt}")
                            cov_routes[rt] += 1
                            n_cov += 1
            # One long chain into fp16, on the planned route.
            chain = ["gelu", ("scale", rows_["[G,N]"]), ("residual", full_op),
                     ("mul", full_op), "relu", ("bias", rows_["[N]"])]
            out = ops.grouped_matmul(a, b, cs["row"], backend="cuda", out_dtype=torch.float16,
                                     epilogue=chain)
            sync(torch, dev)
            check_close(torch, out, lambda od: ops.grouped_matmul(
                a, b, cs["row"], backend="torch", out_dtype=od, epilogue=chain),
                torch.float16, f"grouped coverage chain {gc_}x{m}x{kk}x{n} {dt}")
            cov_routes[route] += 1
            n_cov += 1
    log(f"grouped coverage: {n_cov} ragged/dtype/C/epilogue cases within tolerance, "
        f"by route {cov_routes}")
    return ffn, rows, max_err, cov_routes


@contextlib.contextmanager
def _patched(obj, name, value):
    """``obj.name = value`` inside the block; yields the original."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _fp64_plain(torch, ep):
    """The plain versions' function with fp64 products and sums, rounded
    once to fp32 before the epilogue: another valid summation order, to
    measure how far routing drifts under rounding alone."""
    def fn(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        acc = torch.matmul(a.double(), b.double()).float()
        if c is not None:
            acc = acc + (c.float()[:, None, :] if a.ndim == 3 and c.ndim == 2 else c.float())
        acc = ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
        return acc.to(out_dtype or a.dtype)
    return fn


def _routed_prefill(api, moe_mod, cfg, params, tokens, backend):
    """Prefill logits and every layer's (router params, router input,
    top-k indices)."""
    rec, orig = [], moe_mod._route

    def recording(p, xf, top_k, backend=None):
        out = orig(p, xf, top_k, backend)
        rec.append((p, xf, out[2]))
        return out

    with _patched(moe_mod, "_route", recording):
        logits, _ = api.prefill(cfg, params, {"tokens": tokens}, tokens.shape[1],
                                backend=backend)
    return logits, rec


def _agreement(idx_a, idx_b):
    """Share of top-k assignments of ``idx_a`` that ``idx_b`` also makes
    (per token, in any order), per layer."""
    return (idx_a[..., :, None] == idx_b[..., None, :]).any(-1).float().mean((-1, -2))


def moe_phase(torch, np, cfg, ops, ep, k4, dev):
    """Phase 6: full-width deepseek-moe-16b."""
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ContinuousEngine, ServeEngine, poisson_trace

    n_k1, n_k4 = 8 * cfg.n_layers, 3 * cfg.n_layers  # launches per forward
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != api.param_count(cfg):
        raise AssertionError(f"{n_params} parameters drawn, {api.param_count(cfg)} counted")
    log(f"init {cfg.name}: {n_params / 1e9:.3f} B params "
        f"({api.active_param_count(cfg) / 1e9:.3f} B active per token) on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # (a) routing in a full prefill on the kernels: the plain router on the
    # same layer inputs, and two free-running prefills. Free-running, a
    # 1-ulp difference upstream flips a near-tied expert choice and the flip
    # grows through the later layers, so the kernels-vs-plain agreement is
    # held to the floor this run measures between two valid summation
    # orders of the plain versions (fp32 and fp64 sums), less a margin.
    m = cfg.moe
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        got, rec_c = _routed_prefill(api, moe_mod, cfg, params, tokens, "cuda")
        ref, rec_t = _routed_prefill(api, moe_mod, cfg, params, tokens, "torch")
        fp64 = _fp64_plain(torch, ep)
        plain = ops.backend("torch")
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            _, rec_64 = _routed_prefill(api, moe_mod, cfg, params, tokens, "torch")
        idx_c, idx_t, idx_64 = (torch.stack([r[2] for r in rec]) for rec in (rec_c, rec_t, rec_64))
        idx_same = torch.stack([moe_mod._route(p, xf, m.top_k, "torch")[2] for p, xf, _ in rec_c])
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("prefill logits not finite")
    if tuple(got.shape) != (2, cfg.vocab) or tuple(idx_c.shape) != (cfg.n_layers, 128, m.top_k):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, routing {tuple(idx_c.shape)}")
    same = _agreement(idx_c, idx_same).mean().item()
    free_l = _agreement(idx_c, idx_t)
    free, free_64 = free_l.mean().item(), _agreement(idx_t, idx_64).mean().item()
    free_min = max(free_64 - FREE_ROUTING_MARGIN, FREE_ROUTING_FLOOR)
    log(f"(a) prefill 2x64, {idx_c.numel()} routing assignments: plain router on the kernel "
        f"run's layer inputs agrees on {same:.5f} (gated >= 0.99)")
    log(f"(a) free-running prefills: kernels vs plain agree on {free:.5f} (gated >= "
        f"{free_min:.5f} = max(fp64 floor - {FREE_ROUTING_MARGIN}, {FREE_ROUTING_FLOOR})), "
        f"plain fp32 sums vs plain fp64 sums (the floor) on {free_64:.5f}; per layer "
        f"(kernels vs plain) " + " ".join(f"{x:.3f}" for x in free_l.tolist()))
    log(f"(a) logits (not gated): max|dlogits| {(got - ref).abs().max().item():.4g}, max|logits| "
        f"{ref.abs().max().item():.4g}, argmax agreement "
        f"{(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.2f}")
    if same < 0.99:
        raise AssertionError(f"routing agreement on the same layer inputs {same} < 0.99")
    if free < free_min:
        raise AssertionError(f"free-running routing agreement {free} < {free_min} "
                             f"(fp64 floor {free_64})")
    agree = {"same_input": same, "free_running": free,
             "free_running_plain_fp32_vs_fp64": free_64}
    del rec_c, rec_t, rec_64

    # (a2) one full-width MoE layer on both backends with the same routing,
    # taken from the kernel run's router: prefill- and decode-shaped inputs.
    p = params["blocks"][0]["moe"]
    kw = dict(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
              dispatch=m.dispatch, group_size=m.group_size, dropless=m.dropless)
    gen = torch.Generator(device=dev).manual_seed(2)
    layer_err = 0.0
    for shape in ((4, 128), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            fixed = moe_mod._route(p, x.reshape(-1, cfg.d_model), m.top_k, "cuda")
            with _patched(moe_mod, "_route", lambda *a, **k: fixed):
                y_c, aux_c = moe_mod.moe_apply(p, x, backend="cuda", **kw)
                y_t, aux_t = moe_mod.moe_apply(p, x, backend="torch", **kw)
        delta, scale = (y_c.float() - y_t.float()).abs().max().item(), y_t.float().abs().max().item()
        # Kernel and plain version differ by at most one bf16 ulp in the
        # expert hidden state and the shared MLP's outputs; a few ulps of
        # the largest output bound the layer.
        if not torch.isfinite(y_c.float()).all() or delta > 2e-2 * scale:
            raise AssertionError(f"MoE layer {shape}: max|dy| {delta} > 2e-2 * {scale}")
        if abs(aux_c.item() - aux_t.item()) > 1e-6:
            raise AssertionError(f"MoE layer {shape}: aux {aux_c.item()} != {aux_t.item()}")
        layer_err = max(layer_err, delta)
        log(f"(a) one MoE layer, tokens {shape}, fixed routing: max|dy| {delta:.4g} "
            f"<= 2e-2 * max|y| {scale:.4g}")

    # (b) the second main path: continuous batching over a Poisson trace.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    for w in caught:
        log(f"(b) warning: {w.message}")
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    ops.reset_counts()
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    k4.opope_gemm_grouped.launches = 0
    k4.opope_gemm_grouped.launches_by_route.update(sm90=0, tile=0)
    report = eng.timed_serve(trace)
    launches = {"k1": opope_gemm.launches, "k4": k4.opope_gemm_grouped.launches}
    check_routes(opope_gemm, launches["k1"], "6(b)")
    check_routes(k4.opope_gemm_grouped, launches["k4"], "6(b)", name="K4")
    forwards = report.decode_steps + report.prefill_batches
    plain = ops.backend("torch")
    if (launches["k4"] != n_k4 * forwards or launches["k1"] != n_k1 * forwards
            or plain.calls or plain.grouped_calls
            or ops.backend("cuda").grouped_calls != launches["k4"]):
        raise AssertionError(f"launches {launches} != K1 {n_k1 * forwards}, K4 "
                             f"{n_k4 * forwards} (plain calls {plain.calls}, "
                             f"{plain.grouped_calls} grouped)")
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {r.rid}: bad output {out}")
    log(f"(b) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, "
        f"mean_occupancy {report.mean_occupancy:.3f}, wall {report.wall_time_s:.3f} s, "
        f"{report.tokens_per_sec:.1f} tokens/s, TTFT p50 {report.ttft_p50 * 1e3:.1f} ms, "
        f"ITL p50 {report.itl_p50 * 1e3:.1f} ms (host-issue times); K4 launches "
        f"{launches['k4']} = 3 * {cfg.n_layers} * ({report.decode_steps} + "
        f"{report.prefill_batches}), K1 launches {launches['k1']} = 8 * {cfg.n_layers} * (...), "
        f"every K1 and K4 launch on sm90")
    del eng

    # (b) the lockstep engine.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    opope_gemm.launches = k4.opope_gemm_grouped.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    k4.opope_gemm_grouped.launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    toks = ServeEngine(cfg=cfg, params=params, max_len=80).generate({"tokens": prompts}, 16)
    toks_host = toks.cpu()
    dt = time.perf_counter() - t0
    if tuple(toks_host.shape) != (4, 16) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"static engine output {tuple(toks_host.shape)}")
    if (k4.opope_gemm_grouped.launches, opope_gemm.launches) != (n_k4 * 16, n_k1 * 16):
        raise AssertionError(f"static launches K4 {k4.opope_gemm_grouped.launches}, "
                             f"K1 {opope_gemm.launches}")
    check_routes(opope_gemm, opope_gemm.launches, "6(b) static")
    check_routes(k4.opope_gemm_grouped, k4.opope_gemm_grouped.launches, "6(b) static", name="K4")
    log(f"(b) static: 4 x 64-token prompts, 16 tokens each in {dt:.3f} s "
        f"({64 / dt:.1f} tokens/s), K4 launches {k4.opope_gemm_grouped.launches}, "
        f"K1 launches {opope_gemm.launches}")

    # (c) one lockstep decode step at 4 rows.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i)
        sync(torch, dev)
        n_steps = 8
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = None
        if dev.type == "cuda":
            prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 75 + i),
                                  step_ms, tag="(c)")
    # Byte bounds of the step's GEMMs: every weight read once (the 4 rows
    # of activations add < 0.1 %); 3-D weights are the experts' (K4).
    bound_ms = {"k1": 0.0, "k4": 0.0}
    for t in _leaves(params["blocks"]):
        if t.ndim >= 2:
            bound_ms["k4" if t.ndim == 3 else "k1"] += (
                1e3 * t.numel() * t.element_size() / HBM_BYTES_PER_S)
    dev_ms = None
    if prof is not None:
        dev_ms = {name: sum(ms for key, ms, _ in prof if kernel in key)
                  for name, kernel in (("k4", "opope_grouped_kernel"),
                                       ("k1", "opope_gemm_kernel"))}
        dev_ms["busy"] = sum(ms for _, ms, _ in prof)
        dev_ms.update({f"{k}_byte_bound": v for k, v in bound_ms.items()})
        log(f"(c) decode step, 4 rows: {step_ms:.3f} ms wall; device busy "
            f"{dev_ms['busy']:.3f} ms, K4 {dev_ms['k4']:.3f} ms ({n_k4} launches, byte bound "
            f"{bound_ms['k4']:.3f} ms), K1 {dev_ms['k1']:.3f} ms ({n_k1} launches, byte bound "
            f"{bound_ms['k1']:.3f} ms)")
    return {"continuous": report, "launches": launches, "decode_step_ms": step_ms,
            "device_ms": dev_ms, "routing_agreement": agree, "layer_err": layer_err,
            "params": params}

def q8_check(torch, out, want, transcendental, what):
    """K2/K5 output against the plain version's on the same int8 inputs:
    bitwise where the chain has no transcendental op (and for int8 out);
    else within one ulp of the output dtype, plus 1e-6 of the largest
    magnitude where gelu cancels. Returns the largest absolute difference."""
    if out.dtype == torch.int8 or not transcendental:
        if not torch.equal(out, want):
            bad = (out != want).sum().item()
            raise AssertionError(f"{what}: {bad} elements differ from the plain version "
                                 "(bitwise gate)")
        return 0.0
    ref = want.float()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - ref).abs()
    tol = ulp(torch, ref, out.dtype) + 1e-6 * ref.abs().max()
    bad = (diff > tol).sum().item()
    if bad:
        raise AssertionError(f"{what}: {bad} elements beyond 1 ulp (max err {diff.max().item()})")
    return diff.max().item() if out.numel() else 0.0


def q8_bound(g, m, k, n, out_elem, n_full_operands):
    """Least time in ms of one int8 GEMM (G = g groups) on the card, and what
    bounds it: int8 A and B, the fp32 scales, the output and the bf16 full
    operands moved once each, or 2MNK at the int8 tensor-core rate."""
    nbytes = g * (m * k + k * n + 4 * (m + n) + out_elem * m * n + 2 * m * n * n_full_operands)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * g * m * n * k / INT8_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


Q8_CHAINS = {"none": (), "silu+mul": ("silu", "mul"), "residual": ("residual",),
             "requant_int8": ("requant_int8",)}


def q8_kernel_phase(torch, q8, qz, qb, k4, ep, cfg, mcfg, dev):
    """Phase 7. Returns the timing rows, the largest error of K2 and K5, and
    K5's coverage launches by route."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    d, dff = cfg.d_model, cfg.d_ff
    md, mf, ne = mcfg.d_model, mcfg.moe.d_ff_expert, mcfg.moe.n_experts
    msh = mcfg.moe.d_ff_shared or mcfg.moe.n_shared * mf
    # The quantized GEMMs of one layer: (path, name, G (0: K2), Ms, K, N,
    # chain on the path, out dtype on the path).
    gemms = [
        ("chatglm3-6b mlp", "w_up", 0, (4, 512), d, dff, "none", bf16),
        ("chatglm3-6b mlp", "w_gate", 0, (4, 512), d, dff, "silu+mul", bf16),
        ("chatglm3-6b mlp", "w_down", 0, (4, 512), dff, d, "residual", bf16),
        ("deepseek-moe-16b shared", "w_up", 0, (4, 256), md, msh, "none", bf16),
        ("deepseek-moe-16b shared", "w_gate", 0, (4, 256), md, msh, "silu+mul", bf16),
        ("deepseek-moe-16b shared", "w_down", 0, (4, 256), msh, md, "residual", bf16),
        ("deepseek-moe-16b experts", "w_up", ne, (1, 30, 60), md, mf, "none", bf16),
        ("deepseek-moe-16b experts", "w_gate", ne, (1, 30, 60), md, mf, "silu+mul", bf16),
        ("deepseek-moe-16b experts", "w_down", ne, (1, 30, 60), mf, md, "none", f32),
    ]

    def quantized(g, m, k, n):
        """The path's int8 operands: bf16 activations and weights quantized
        as the q8 backends do (per row / column, per group for K5)."""
        lead = (g,) if g else ()
        a = torch.randn(lead + (m, k), generator=gen, device=dev).to(bf16)
        b = (torch.randn(lead + (k, n), generator=gen, device=dev) * k ** -0.5).to(bf16)
        aq, bq = (qb.quantize_grouped_operands if g else qb.quantize_operands)(a, b)
        return b, aq.q, aq.scale, bq.q, bq.scale

    def chain_operands(chain, g, m, n, out_dtype):
        steps = Q8_CHAINS[chain]
        full = (torch.randn(((g,) if g else ()) + (m, n), generator=gen, device=dev).to(bf16),)
        scalar = (torch.full((1, 1, 1) if g else (1, 1), 0.02, device=dev),)
        ops_ = {"none": (), "silu+mul": full, "residual": full, "requant_int8": scalar}[chain]
        return steps, ops_, (torch.int8 if chain == "requant_int8" else out_dtype)

    errs = {"k2": 0.0, "k5": 0.0}
    n_checks = 0
    # Correctness at every path shape, every chain.
    for g, ms, kk, n, out_dtype in sorted({(g, ms, kk, n, od) for _, _, g, ms, kk, n, _, od in gemms},
                                          key=str):
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        tile = functools.partial(q8._launch_grouped if g else q8._launch, route="tile")
        for m in ms:
            _, a, sa, b, sb = quantized(g, m, kk, n)
            # Every path shape plans on sm90 (K5 with one split).
            plan = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), b.data_ptr()) if g else
                    q8._plan(m, n, kk, a.data_ptr(), b.data_ptr()))
            if plan.route != "sm90":
                raise AssertionError(f"{'K5' if g else 'K2'} G={g} M={m} K={kk} N={n}: planned "
                                     f"on {plan.route}")
            for chain in Q8_CHAINS:
                steps, ops_, od = chain_operands(chain, g, m, n, out_dtype)
                out = kern(a, sa, b, sb, out_dtype=od, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                want = plain(a, sa, b, sb, out_dtype=od, epilogue=steps, epilogue_operands=ops_)
                what = f"q8 G={g} M={m} K={kk} N={n} {chain}"
                err = q8_check(torch, out, want, "silu" in steps, what)
                # The same call on the tile route, held the same way.
                q8_check(torch, tile(a, sa, b, sb, out_dtype=od, epilogue=steps,
                                     epilogue_operands=ops_),
                         want, "silu" in steps, what + " (tile route)")
                errs["k5" if g else "k2"] = max(errs["k5" if g else "k2"], err)
                n_checks += 1
                log(f"check {what} -> {str(od).replace('torch.', '')} on sm90 (tile rows "
                    f"{plan.bm}, {plan.splits} splits) and tile: max_abs_err {err:.3g} ok")
            if not g and plan.splits > 1:
                # Split K sums int32 partials: a repeat gives the same bits.
                outs = [kern(a, sa, b, sb, out_dtype=torch.bfloat16) for _ in range(2)]
                if not torch.equal(outs[0], outs[1]):
                    raise AssertionError(f"K2 M={m} K={kk} N={n}: split-K repeat differs")
            del a, b, out, want

    # Timing at the path's (shape, chain) pairs, weights cold in L2, beside
    # the plain version, torch._int_mm (K2 only) and one per-call weight
    # quantization (what the q8 backends run before each kernel). K2 and K5
    # on their planned route and on the tile route, K4's sm90 route on the
    # same shapes in bf16 (K5's yardstick: no single PyTorch call computes a
    # grouped int8 GEMM) and the _int_mm lane by device time (queued_ms: CUDA events around
    # calls queued behind a sleeping kernel; their launches are shorter than
    # the host's issue time), and K2 and K5 also by CUDA events around a loop
    # (event_ms, the host's issue rate included, as they were first timed);
    # the plain versions and the quantization by CUDA events.
    rows = []
    for path, name, g, ms, kk, n, chain, out_dtype in gemms:
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        launch = q8._launch_grouped if g else q8._launch
        tile = functools.partial(launch, route="tile")
        n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / (max(g, 1) * kk * n))))
        bufs = [quantized(g, max(ms), kk, n) for _ in range(n_bufs)]
        n_iter = max(20, n_bufs)
        for m in ms:
            a, sa = bufs[0][1][..., :m, :].contiguous(), bufs[0][2][..., :m, :].contiguous()
            steps, ops_, _ = chain_operands(chain, g, m, n, out_dtype)

            def run(fn, i):
                return fn(a, sa, bufs[i][3], bufs[i][4], out_dtype=out_dtype, epilogue=steps,
                          epilogue_operands=ops_)

            plan = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), bufs[0][3].data_ptr()) if g else
                    q8._plan(m, n, kk, a.data_ptr(), bufs[0][3].data_ptr()))
            ms_e = time_ms(torch, lambda i: run(kern, i), n_bufs)
            ms_k = queued_ms(torch, lambda i: run(kern, i % n_bufs), n_iter)
            ms_tile = queued_ms(torch, lambda i: run(tile, i % n_bufs), n_iter)
            ms_p = time_ms(torch, lambda i: run(plain, i), n_bufs)
            ms_q = time_ms(torch, lambda i: qz.quantize(
                bufs[i][0], "int8", axis=(0, 2) if g else 1), n_bufs, warmup=n_bufs)
            lib_ms = lib_e = ms_k4 = None
            if g:
                a_bf = torch.randn((g, m, kk), generator=gen, device=dev).to(bf16)
                ms_k4 = queued_ms(torch, lambda i: k4.opope_gemm_grouped(
                    a_bf, bufs[i % n_bufs][0], out_dtype=out_dtype, epilogue=steps,
                    epilogue_operands=ops_), n_iter)
                k4_route = k4._plan(m, n, kk, bf16, a_bf.data_ptr(),
                                    bufs[0][0].data_ptr()).route
                del a_bf
            else:
                # torch._int_mm needs M > 16: M is padded to 32 with zero rows.
                m_lib = 32 if m <= 16 else m
                a_lib = torch.zeros((m_lib, kk), dtype=torch.int8, device=dev)
                a_lib[:m] = a
                sa_lib = torch.ones((m_lib, 1), device=dev)
                sa_lib[:m] = sa
                b_cm = [x[3].t().contiguous().t() for x in bufs]

                def lib(i):
                    return torch._int_mm(a_lib, b_cm[i]).float() * (sa_lib * bufs[i][4])
                lib_e = time_ms(torch, lib, n_bufs)
                lib_ms = queued_ms(torch, lambda i: lib(i % n_bufs), n_iter)
                del b_cm
            out = run(kern, 0)
            err = q8_check(torch, out, run(plain, 0), "silu" in steps, f"timed {path} {name} M={m}")
            out_elem = out.element_size()
            bound_ms, bound_by = q8_bound(max(g, 1), m, kk, n, out_elem, len(ops_))
            row = {"path": path, "name": name, "g": g, "m": m, "k": kk, "n": n, "epilogue": chain,
                   "out_dtype": str(out_dtype).replace("torch.", ""), "route": plan.route,
                   "config": plan.config, "tile_rows": plan.bm, "splits": plan.splits,
                   "ms": ms_k, "tile_ms": ms_tile, "event_ms": ms_e, "plain_ms": ms_p,
                   "library_ms": lib_ms, "library_event_ms": lib_e, "bound_ms": bound_ms,
                   "bound_by": bound_by, "weight_quant_ms": ms_q, "max_abs_err": err,
                   "tops": 2 * max(g, 1) * m * n * kk / ms_k / 1e9}
            if g:
                row.update(k4_sm90_ms=ms_k4, k4_route=k4_route)
            rows.append(row)
            log(f"time {path} {name} G={g} M={m} K={kk} N={n} chain={chain}: "
                f"sm90 {ms_k:.4f} ms device ({plan.bm} rows, {plan.stages} stages, "
                f"{plan.splits} splits; {row['tops']:.1f} TOP/s; {ms_e:.4f} ms by CUDA events), "
                f"tile route {ms_tile:.4f} ms device, "
                + (f"K4 {k4_route} bf16 {ms_k4:.4f} ms device, " if g else "")
                + f"plain {ms_p:.4f} ms, "
                + (f"torch._int_mm+dequant {lib_ms:.4f} ms device ({lib_e:.4f} by CUDA events; "
                   f"M padded to {m_lib}), " if lib_ms is not None else "")
                + f"bound {bound_ms:.4f} ms ({bound_by}); per-call weight quantization "
                f"{ms_q:.4f} ms")
        del bufs

    # Coverage: ragged shapes, every C form, op and out dtype, on the route
    # each case plans. The tile route: K or N off a multiple of 16 (K2, and
    # K5 at G = 3). The sm90 route: for K2, M of 1, 5, 65 and 130 on the 8-
    # and 128-row tiles, K and N off the 128-byte panel and tile; for K5 at
    # G = 3 and 64, M of 1, 5, 8, 9, 64, 65 and 130 (both tiles, one or two
    # of them), K tails of 144, 272, 400 and 1040, N of 144, 208 and 272.
    tile_cases = ((5, 40, 24), (130, 300, 200), (64, 1000, 192))
    cov_cases = ([(0, c, "tile") for c in tile_cases]
                 + [(0, c, "sm90") for c in ((1, 16, 16), (5, 144, 272), (65, 400, 144),
                                             (130, 1040, 208))]
                 + [(3, c, "tile") for c in tile_cases]
                 + [(3, c, "sm90") for c in ((1, 144, 272), (5, 1040, 208), (8, 400, 144),
                                             (9, 144, 208), (65, 272, 144), (130, 1040, 208))]
                 + [(64, c, "sm90") for c in ((1, 144, 144), (64, 1040, 208))])
    n_cov = 0
    k2_before = dict(q8.opope_gemm_q8.launches_by_route)
    k5_before = dict(q8.opope_gemm_q8_grouped.launches_by_route)
    for g, (m, kk, n), want_route in cov_cases:
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        lead = (g,) if g else ()
        a = torch.randint(-127, 128, lead + (m, kk), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, lead + (kk, n), generator=gen, device=dev,
                          dtype=torch.int8)
        route = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), b.data_ptr()) if g else
                 q8._plan(m, n, kk, a.data_ptr(), b.data_ptr())).route
        if route != want_route:
            raise AssertionError(f"q8 coverage G={g} {m}x{kk}x{n} planned on {route}, "
                                 f"want {want_route}")
        sa = torch.rand(lead + (m, 1), generator=gen, device=dev) * 1e-3
        sb = torch.rand(lead + (1, n), generator=gen, device=dev) * 1e-2
        row_op = torch.randn(lead + (1, n) if g else (1, n), generator=gen, device=dev)
        full_op = torch.randn(lead + (m, n), generator=gen, device=dev).to(bf16)
        scalar = torch.full((1, 1, 1) if g else (1, 1), 0.05, device=dev)
        cs = {"none": None, "row": torch.randn(lead + (n,), generator=gen, device=dev),
              "full": torch.randn(lead + (m, n), generator=gen, device=dev).to(bf16)}
        for c_name, c in cs.items():
            for name in ep.epilogue_ops():
                ops_ = {"none": (), "row": (row_op,), "full": (full_op,),
                        "scalar": (scalar,)}[ep.op_kind(name)]
                for od in ((torch.int8,) if name == "requant_int8" else (f32, bf16)):
                    out = kern(a, sa, b, sb, c, out_dtype=od, epilogue=(name,),
                               epilogue_operands=ops_)
                    sync(torch, dev)
                    want = plain(a, sa, b, sb, c, out_dtype=od, epilogue=(name,),
                                 epilogue_operands=ops_)
                    q8_check(torch, out, want, name in ("gelu", "silu", "swish"),
                             f"q8 coverage G={g} {m}x{kk}x{n} C={c_name} {name} -> {od} "
                             f"on {route}")
                    n_cov += 1
        chain = ("bias", "scale", "residual", "mul", "relu", "requant_int8")
        ops_ = (cs["row"].reshape(row_op.shape), row_op, full_op, full_op, scalar)
        out = kern(a, sa, b, sb, cs["full"], out_dtype=torch.int8, epilogue=chain,
                   epilogue_operands=ops_)
        q8_check(torch, out, plain(a, sa, b, sb, cs["full"], out_dtype=torch.int8,
                                   epilogue=chain, epilogue_operands=ops_), False,
                 f"q8 coverage chain G={g} {m}x{kk}x{n} on {route}")
        n_cov += 1
        # The int32 accumulator is exact: with unit scales and
        # |acc| < 2^24 the fp32 output is the integer product.
        ones_a, ones_b = torch.ones_like(sa), torch.ones_like(sb)
        out = kern(a, ones_a, b, ones_b)
        exact = torch.matmul(a.double(), b.double())
        if exact.abs().max() >= 2 ** 24 or not torch.equal(out.double(), exact):
            raise AssertionError(f"q8 G={g} {m}x{kk}x{n} on {route}: accumulator not exact")
        n_cov += 1
    k2_cov = {r: q8.opope_gemm_q8.launches_by_route[r] - k2_before[r] for r in k2_before}
    k5_cov = {r: q8.opope_gemm_q8_grouped.launches_by_route[r] - k5_before[r]
              for r in k5_before}
    if not all(k2_cov.values()) or not all(k5_cov.values()):
        raise AssertionError(f"q8 coverage launches by route: K2 {k2_cov}, K5 {k5_cov}: a "
                             "route went unchecked")
    # K5 at decode: experts no token reached hold zero rows (scale 1e-12/127,
    # q = 0) and must give exactly zero outputs.
    x = torch.randn((ne, 1, md), generator=gen, device=dev).to(bf16)
    x[::2] = 0
    w = (torch.randn((ne, md, mf), generator=gen, device=dev) * md ** -0.5).to(bf16)
    xq, wq = qb.quantize_grouped_operands(x, w)
    if q8._plan_grouped(ne, 1, mf, md, xq.q.data_ptr(), wq.q.data_ptr()).route != "sm90":
        raise AssertionError("K5 zero-capacity case: not planned on sm90")
    out = q8.opope_gemm_q8_grouped(xq.q, xq.scale, wq.q, wq.scale)
    if out[::2].any() or not out[1::2].any():
        raise AssertionError("K5: zero capacity rows did not give exactly zero outputs")
    log(f"q8: {n_checks} path-shape checks (K2 and K5 on sm90 and on the tile route), {n_cov} "
        f"ragged/C/epilogue/accumulator cases (launches by route: K2 {k2_cov}, K5 {k5_cov}) "
        f"and the zero-capacity decode case on sm90 bitwise (transcendental chains within "
        f"1 ulp)")
    return rows, errs, k5_cov


def _greedy_decode(torch, api, cfg, params, prompts, gen, policy):
    """``benchmarks/quant_bench.py::greedy_decode``: prefill with fp32
    caches, then ``gen - 1`` greedy decode steps; returns [B, gen] tokens."""
    logits, caches = api.prefill(cfg, params, {"tokens": prompts}, prompts.shape[1] + gen + 1,
                                 torch.float32, backend=policy)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = api.decode(cfg, params, tok, caches, prompts.shape[1] + i,
                                    backend=policy)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def q8_model_phase(torch, np, cfg, params, policy, plain_policy, per_layer, ops, ep, kernels,
                   dev, tag):
    """Phase 8 for one model on its full-width weights, under ``policy`` on
    the kernels and ``plain_policy`` on the plain versions. ``per_layer``
    maps each kernel name of ``kernels`` to its launches per layer and
    forward on the quantized main path."""
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod

    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(4)
    # (a) one layer, both backends, the same input (and, for MoE, the
    # kernel run's routing).
    layer_err = 0.0
    for shape in ((4, 64), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(shape[1], device=dev).expand(shape)
        rec, orig = [], moe_mod._route

        def recording(*a, **k):
            rec.append(orig(*a, **k))
            return rec[-1]

        with torch.inference_mode():
            with _patched(moe_mod, "_route", recording):
                y_k = tf_mod._block_apply(cfg, params["blocks"][0], x, positions=pos, cache=None,
                                          backend=policy)[0]
            with _patched(moe_mod, "_route", lambda *a, **k: rec[0] if rec else orig(*a, **k)):
                y_p = tf_mod._block_apply(cfg, params["blocks"][0], x, positions=pos, cache=None,
                                          backend=plain_policy)[0]
        delta, scale = (y_k.float() - y_p.float()).abs().max().item(), y_p.float().abs().max().item()
        # K1 and its plain version differ by at most one bf16 ulp; an int8
        # value downstream may round the other way, one quantization step.
        if not torch.isfinite(y_k.float()).all() or delta > 2e-2 * scale:
            raise AssertionError(f"{tag} layer {shape}: max|dy| {delta} > 2e-2 * {scale}")
        layer_err = max(layer_err, delta)
        log(f"{tag} (a) one layer, tokens {shape}: kernels vs plain max|dy| {delta:.4g} "
            f"<= 2e-2 * max|y| {scale:.4g}")

    # (b) all-layer prefill logits: kernels vs plain, against two plain
    # summation orders (fp32 and fp64 sums) of the same run.
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=policy)
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=plain_policy)
        fp64 = _fp64_plain(torch, ep)
        plain = ops.backend("torch")
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            ref64, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=plain_policy)
        bf, _ = api.prefill(cfg, params, {"tokens": tokens}, 64)
    for name, t in (("kernels", got), ("plain", ref), ("plain fp64", ref64)):
        if not torch.isfinite(t).all() or tuple(t.shape) != (2, cfg.vocab):
            raise AssertionError(f"{tag} prefill logits ({name}) {tuple(t.shape)} not finite")

    def rms(x):
        return x.double().pow(2).mean().sqrt().item()

    d_k, d_f = rms(got - ref), rms(ref - ref64)
    logit_gate = Q8_LOGIT_FLOOR_FACTOR * d_f
    log(f"{tag} (b) prefill 2x64 logits: kernels vs plain RMS {d_k:.4g} (max {(got - ref).abs().max().item():.4g}); "
        f"plain fp32 vs fp64 sums RMS {d_f:.4g} (the floor; gate {Q8_LOGIT_FLOOR_FACTOR} x = "
        f"{logit_gate:.4g}); max|logits| {ref.abs().max().item():.4g}; argmax agreement "
        f"{(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.2f}")
    if d_k > logit_gate:
        raise AssertionError(f"{tag} prefill logits: kernels vs plain RMS {d_k} > "
                             f"{Q8_LOGIT_FLOOR_FACTOR} x floor {d_f}")
    q8_vs_bf16 = {"rms": rms(got - bf), "max": (got - bf).abs().max().item(),
                  "max_logit": bf.abs().max().item(),
                  "argmax_agreement": (got.argmax(-1) == bf.argmax(-1)).float().mean().item()}
    log(f"{tag} (c) q8 vs bf16 prefill logits (not gated): RMS {q8_vs_bf16['rms']:.4g}, "
        f"max {q8_vs_bf16['max']:.4g} of max|logits| {q8_vs_bf16['max_logit']:.4g}, argmax "
        f"agreement {q8_vs_bf16['argmax_agreement']:.2f}")
    del got, ref, ref64, bf

    # (d) the quantized main path: a 4 x 64-token prefill and 16 greedy
    # decode steps through api.prefill / api.decode, every launch counted.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    n_fwd = 17
    ops.reset_counts()
    for fn in kernels.values():
        fn.launches = 0
    for name in ("K1", "K2", "K5"):
        kernels[name].launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks = _greedy_decode(torch, api, cfg, params, prompts, n_fwd, policy)
        toks_host = toks.cpu()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = {name: per_layer.get(name, 0) * L * n_fwd for name in kernels}
    plain_calls = {name: (ops.backend(name).calls, ops.backend(name).grouped_calls)
                   for name in ("torch", "torch_q8")}
    if launches != want or any(sum(c) for c in plain_calls.values()):
        raise AssertionError(f"{tag} launches {launches} != {want} (plain calls {plain_calls})")
    for name in ("K1", "K2", "K5"):
        check_routes(kernels[name], launches[name], f"{tag} (d)", name=name)
    if tuple(toks_host.shape) != (4, n_fwd) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"{tag} greedy tokens {tuple(toks_host.shape)}")
    log(f"{tag} (d) greedy 4 x 64 prompt + 16 decode steps in {wall:.3f} s "
        f"({4 * n_fwd / wall:.1f} tokens/s); launches {launches} = per layer "
        f"{per_layer} x {L} layers x {n_fwd} forwards, every K1, K2 and K5 launch on sm90; "
        f"plain calls 0")

    # (e) one decode step at 4 rows: wall time and its kernel split.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96, backend=policy)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i, backend=policy)
        sync(torch, dev)
        n_steps = 8
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i, backend=policy)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 75 + i,
                                                          backend=policy), step_ms, tag=f"{tag} (e)")
    dev_ms = None
    if prof is not None:
        # Each kernel's name holds its own key and no other's (K5's two
        # routes both "opope_q8_grouped_kernel"): a kernel whose name holds
        # two would be booked twice, and fails the run.
        names = {"K1": "opope_gemm_kernel", "K4": "opope_grouped_kernel",
                 "K2": "opope_q8_gemm_kernel", "K5": "opope_q8_grouped_kernel"}
        for key, _, _ in prof:
            if sum(v in key for v in names.values()) > 1:
                raise AssertionError(f"{tag} (e): kernel {key} matches two kernels' names")
        dev_ms = {k: sum(ms for key, ms, _ in prof if v in key) for k, v in names.items()}
        missing = [k for k in names if launches.get(k) and not dev_ms[k]]
        if missing:
            raise AssertionError(f"{tag} (e): the profiled decode step books no device time "
                                 f"to {missing}, which the path launches")
        dev_ms["busy"] = sum(ms for _, ms, _ in prof)
        dev_ms["other"] = dev_ms["busy"] - sum(dev_ms[k] for k in names)
        log(f"{tag} (e) decode step, 4 rows: {step_ms:.3f} ms wall; device busy "
            f"{dev_ms['busy']:.3f} ms: " + ", ".join(f"{k} {dev_ms[k]:.3f} ms" for k in names)
            + f", other kernels (the per-call quantization passes among them) "
            f"{dev_ms['other']:.3f} ms")
    return {"launches": launches, "layer_err": layer_err, "logits_rms": d_k,
            "logits_floor_rms": d_f, "q8_vs_bf16": q8_vs_bf16, "greedy_s": wall,
            "decode_step_ms": step_ms, "device_ms": dev_ms}


# K3 against its plain version: fp32 within rtol = atol = 2e-4 (the
# reference's own tolerance; only the order of sums and the exp
# implementation differ). bf16 (P and the output round to bf16 at places
# that differ by the running max): each element within ATTN_BF16_TOL +
# ATTN_BF16_TOL·|plain| (the H100 measured at most 0.0039 at the prefill
# row, where |out| reaches 1), and the error's RMS within ATTN_BF16_RMS of
# the plain output's RMS. Random attention outputs over 2048 keys are
# about 0.04 in size, so the RMS gate is what catches a dropped or
# misweighted KV panel there (one panel of 32 moves the RMS by ~0.18).
ATTN_F32_TOL = 2e-4
ATTN_BF16_TOL = 1e-2
ATTN_BF16_RMS = 2e-2


def attn_bound(b, h, s, t, d, causal, elem):
    """Least time in ms of one K3 call, and what bounds it: q, k, v and the
    output moved once each, or 4·D flops for each (query, valid key) pair
    (causal: the pairs under the mask aligned to the end of the keys) at
    the bf16 tensor-core rate."""
    t_bytes = elem * b * h * 2 * (s + t) * d / HBM_BYTES_PER_S
    t_ops = attn_flops(b, h, s, t, d, causal) / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_flops(b, h, s, t, d, causal):
    """4·D flops for each (query, valid key) pair (causal: under the mask
    aligned to the end of the keys): Q Kᵀ and P·V."""
    pairs = sum(max(0, min(r + t - s + 1, t)) for r in range(s)) if causal else s * t
    return 4 * b * h * pairs * d


def attn_check(torch, out, want, what):
    """K3's output against its plain version's (or another attention's) on
    the same inputs, at the gates of ``out``'s dtype; returns the largest
    absolute difference and the difference's RMS over the reference's."""
    bf16 = out.dtype == torch.bfloat16
    out, want = out.float(), want.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = out - want
    err = diff.abs().max().item()
    rel_rms = (diff.square().mean().sqrt() / want.square().mean().sqrt().clamp(min=1e-30)).item()
    tol = ATTN_BF16_TOL if bf16 else ATTN_F32_TOL
    torch.testing.assert_close(out, want, rtol=tol, atol=tol, msg=lambda m: f"{what}: {m}")
    if bf16 and rel_rms > ATTN_BF16_RMS:
        raise AssertionError(f"{what}: error RMS {rel_rms} x the output's > {ATTN_BF16_RMS}")
    return err, rel_rms


def attention_scan_phase(torch, F, kscan, mattn, cfg, jcfg, shape_32k, dev):
    """Phase 9: K3 and K6 through the ``kernels`` entry points, at the width
    of chatglm3-6b's attention and of jamba-v0.1's mamba scan. Returns the
    two kernels' records."""
    import importlib

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.opope_attention import (
        opope_attention, opope_attention_bhsd, opope_attention_plain)

    k3 = importlib.import_module("repro_torch.kernels.opope_attention")

    gen = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim_

    def qkv(b, s, t):
        """bf16 q [B, S, H, D] and k, v [B, T, Hkv, D]: the model's layout."""
        return (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16),
                torch.randn((b, t, hkv, d), generator=gen, device=dev).to(bf16),
                torch.randn((b, t, hkv, d), generator=gen, device=dev).to(bf16))

    def heads(q, k, v):
        """[B, H, S, D] views of q and of k, v with their KV heads expanded."""
        return (q.transpose(1, 2), k.repeat_interleave(h // hkv, dim=2).transpose(1, 2),
                v.repeat_interleave(h // hkv, dim=2).transpose(1, 2))

    # (a) the main path: chatglm3-6b's attention at a prefill, a chunk
    # continuation, a decode row and without a mask, then one scan at
    # jamba's width (d_inner * d_state columns, train_4k's sequence), all
    # through the entry points with every launch counted.
    attn_rows = [("prefill", 4, 2048, 2048, True), ("continuation", 4, 512, 2048, True),
                 ("decode", 4, 1, 2048, True), ("non-causal", 4, 2048, 2048, False)]
    inputs = {name: qkv(b, s, t) for name, b, s, t, _ in attn_rows}
    views = {name: heads(*x) for name, x in inputs.items()}
    s_scan, n_state = 4096, jcfg.mamba.expand * jcfg.d_model * jcfg.mamba.d_state
    decay = 0.2 + 0.79 * torch.rand((s_scan, n_state), generator=gen, device=dev)
    update = torch.randn((s_scan, n_state), generator=gen, device=dev)
    # The route the plan gives each row: every one of them is sm90's (the
    # decode row too: measured beside the tile route, it is faster there).
    routes = {name: k3._plan(views[name][0].shape, t, bf16, causal,
                             [x.stride() for x in views[name]],
                             [x.data_ptr() for x in views[name]]).route
              for name, _, _, t, causal in attn_rows}
    if set(routes.values()) != {"sm90"}:
        raise AssertionError(f"phase 9 K3 rows off the sm90 route: {routes}")
    sync(torch, dev)
    opope_attention.launches = 0
    opope_attention.launches_by_route = {"sm90": 0, "tile": 0}
    kscan.opope_chunked_scan.launches = 0
    outs = {name: opope_attention_bhsd(*views[name], causal=causal)
            for name, _, _, _, causal in attn_rows}
    states = kscan.opope_chunked_scan(decay, update)
    sync(torch, dev)
    launches = {"k3": opope_attention.launches, "k6": kscan.opope_chunked_scan.launches}
    k3_by_route = dict(opope_attention.launches_by_route)
    if launches != {"k3": len(attn_rows), "k6": 1}:
        raise AssertionError(f"phase 9 launches {launches} != K3 {len(attn_rows)}, K6 1")
    if k3_by_route != {"sm90": len(attn_rows), "tile": 0}:
        raise AssertionError(f"phase 9 K3 launches by route {k3_by_route}, want all "
                             f"{len(attn_rows)} on sm90")
    log(f"9 (a) main path: {len(attn_rows)} opope_attention_bhsd calls at {h} heads x head dim "
        f"{d} and one opope_chunked_scan over [{s_scan}, {n_state}]: launches {launches}, K3 "
        f"by route {k3_by_route}")

    # Each output against the plain version, then the same call (the
    # strided [B, H, S, D] views the kernel reads in place) timed by device
    # time (queued_ms) on the planned route and on the tile route, beside
    # SDPA (the library lane: never called by the port), the plain version
    # (CUDA events: its many kernels) and the bound. Launches made for
    # timing and comparison are not the main path's and are not counted in
    # `launches`.
    rows, k3_err = [], 0.0
    for name, b, s, t, causal in attn_rows:
        qh, kh, vh = views.pop(name)
        want = opope_attention_plain(qh, kh, vh, causal=causal)
        err, rel_rms = attn_check(torch, outs[name], want, f"K3 {name} B={b} S={s} T={t}")
        k3_err = max(k3_err, err)
        tile_out = k3._launch(qh, kh, vh, causal, 128, 128, route="tile")
        attn_check(torch, tile_out, want, f"K3 {name} on the tile route")
        del want, tile_out
        ms = queued_ms(torch, lambda i: opope_attention_bhsd(qh, kh, vh, causal=causal))
        ms_tile = queued_ms(torch, lambda i: k3._launch(qh, kh, vh, causal, 128, 128,
                                                        route="tile"))
        plain_ms = time_ms(torch, lambda i: opope_attention_plain(qh, kh, vh, causal=causal),
                           1, iters=3, warmup=1)
        # SDPA's is_causal is aligned to the start of the keys: S != T takes
        # the end-aligned mask explicitly.
        mask = (torch.ones((s, t), dtype=torch.bool, device=dev).tril(t - s)
                if causal and s != t else None)
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                 is_causal=causal and mask is None)
        lib_ms = queued_ms(torch, lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None))
        lib_diff = (lib_out.float() - outs[name].float()).abs().max().item()
        bound_ms, bound_by = attn_bound(b, h, s, t, d, causal, 2)
        tflops = attn_flops(b, h, s, t, d, causal) / (ms * 1e-3) / 1e12
        rows.append({"name": name, "b": b, "h": h, "s": s, "t": t, "d": d, "causal": causal,
                     "dtype": "bfloat16", "route": routes[name], "ms": ms,
                     "ms_tile_route": ms_tile, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "tflops": tflops,
                     "max_abs_err": err, "err_rms_over_out_rms": rel_rms,
                     "sdpa_max_abs_diff": lib_diff})
        log(f"9 (a) K3 {name} B={b} H={h} S={s} T={t} D={d} causal={causal}: vs plain max abs "
            f"err {err:.3g} (gate {ATTN_BF16_TOL} + {ATTN_BF16_TOL} |plain|), error RMS / output "
            f"RMS {rel_rms:.3g} (gate {ATTN_BF16_RMS}); device time {routes[name]} route "
            f"{ms:.4f} ms ({tflops:.0f} TFLOP/s), tile route {ms_tile:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.4f} ms "
            f"(CUDA events); |K3 - SDPA| max {lib_diff:.3g} (not gated)")
        del qh, kh, vh, lib_out

    # (b) the same prefill against the model's own attention, which takes
    # the [B, S, H, D] layout and the 2 unexpanded KV heads.
    q, k, v = inputs["prefill"]
    with torch.inference_mode():
        model_out = mattn.blockwise_attention(q, k, v, causal=True)
    if not torch.isfinite(model_out.float()).all():
        raise AssertionError("blockwise_attention: non-finite output")
    model_err, model_rms = attn_check(torch, outs["prefill"].transpose(1, 2), model_out,
                                      "K3 prefill vs blockwise_attention")
    log(f"9 (b) K3 prefill against models/attention.py::blockwise_attention (GQA, {hkv} KV "
        f"heads): max abs err {model_err:.3g}, error RMS / output RMS {model_rms:.3g} (the "
        "bf16 gates of (a))")
    del inputs, outs, model_out

    # Coverage, on each route that takes the case (tile: all; sm90: bf16 at
    # head dims 64 and 128 but causal S > T) and through both entry points:
    # every test shape of the reference (fp32 and bf16), S > T causal rows
    # without a valid key at two block sizes, head dim 16; and for the sm90
    # route S and T off the 128-row tile, continuations whose diagonal
    # crosses a panel, head dim 64, B·H > 1 on [B, S, H, D] views, and T of
    # one key.
    n_cov, cov_routes = 0, {"sm90": 0, "tile": 0}
    cov = [(1, 1, 128, 128, 64, True, 64, False), (1, 1, 100, 160, 64, True, 64, False),
           (1, 1, 96, 128, 32, False, 64, False), (1, 1, 77, 77, 64, True, 64, False),
           (1, 1, 256, 256, 128, True, 64, False), (2, 3, 64, 64, 32, True, 32, False),
           (1, 1, 96, 64, 64, True, 32, False), (1, 1, 96, 64, 64, True, 64, False),
           (2, 2, 200, 70, 32, True, 64, False), (2, 2, 200, 70, 32, True, 128, False),
           (2, 4, 96, 64, 16, True, 128, False), (1, 4, 1, 300, 128, True, 128, False),
           (1, 1, 129, 300, 128, True, 128, False), (1, 1, 127, 127, 128, False, 128, False),
           (2, 3, 200, 333, 128, True, 128, True), (1, 2, 129, 1000, 64, True, 128, False),
           (3, 5, 257, 700, 64, True, 128, True), (2, 4, 300, 300, 64, False, 128, True),
           (1, 1, 1, 1, 128, True, 128, False), (1, 2, 5, 1, 128, False, 128, False),
           (1, 1, 1, 1, 64, False, 128, False)]
    for dt in (f32, bf16):
        for b, hh, s, t, dd, causal, blk, bshd in cov:
            if bshd:  # [B, H, N, D] views of [B, N, H, D] tensors
                q, k, v = (torch.randn((b, n, hh, dd), generator=gen, device=dev).to(dt)
                           .transpose(1, 2) for n in (s, t, t))
            else:
                q, k, v = (torch.randn((b, hh, n, dd), generator=gen, device=dev).to(dt)
                           for n in (s, t, t))
            what = f"K3 coverage {b}x{hh}x{s}x{t}x{dd} causal={causal} blocks={blk} {dt}"
            want = opope_attention_plain(q, k, v, causal=causal, block_q=blk, block_k=blk)
            plan = k3._plan(q.shape, t, dt, causal, [x.stride() for x in (q, k, v)],
                            [x.data_ptr() for x in (q, k, v)])
            for route in ("tile", "sm90") if plan.route == "sm90" else ("tile",):
                out = k3._launch(q, k, v, causal, blk, blk, route=route)
                sync(torch, dev)
                err, _ = attn_check(torch, out, want, f"{what} on the {route} route")
                k3_err = max(k3_err, err)
                cov_routes[route] += 1
            out = opope_attention_bhsd(q, k, v, causal=causal, block_q=blk, block_k=blk)
            sync(torch, dev)
            attn_check(torch, out, want, what)
            out = opope_attention(q[0, 0], k[0, 0], v[0, 0], causal=causal, block_q=blk,
                                  block_k=blk)
            attn_check(torch, out, want[0, 0], f"K3 single-head coverage {s}x{t}x{dd} {dt}")
            n_cov += 1
    log(f"9 (a) K3 coverage: {n_cov} ragged/dtype/block/head-dim/layout cases within "
        f"tolerance through both entry points, and by route {cov_routes}")

    # chatglm3-6b's prefill_32k sequence: kernel and SDPA only.
    s32 = shape_32k.seq_len
    qh, kh, vh = heads(*qkv(1, s32, s32))
    out = opope_attention_bhsd(qh, kh, vh)
    sync(torch, dev)
    if not torch.isfinite(out.float()).all():
        raise AssertionError("K3 prefill_32k: non-finite output")
    route_32k = k3._plan(qh.shape, s32, bf16, True, [x.stride() for x in (qh, kh, vh)],
                         [x.data_ptr() for x in (qh, kh, vh)]).route
    ms_32k = queued_ms(torch, lambda i: opope_attention_bhsd(qh, kh, vh), iters=3, warmup=1)
    tile_32k = queued_ms(torch, lambda i: k3._launch(qh, kh, vh, True, 128, 128, route="tile"),
                         iters=3, warmup=1)
    lib_32k = queued_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), iters=3, warmup=1)
    diff_32k = (F.scaled_dot_product_attention(qh, kh, vh, is_causal=True).float()
                - out.float()).abs().max().item()
    bound_32k, by_32k = attn_bound(1, h, s32, s32, d, True, 2)
    tflops_32k = attn_flops(1, h, s32, s32, d, True) / (ms_32k * 1e-3) / 1e12
    rows.append({"name": shape_32k.name, "b": 1, "h": h, "s": s32, "t": s32, "d": d,
                 "causal": True, "dtype": "bfloat16", "route": route_32k, "ms": ms_32k,
                 "ms_tile_route": tile_32k, "plain_ms": None, "library_ms": lib_32k,
                 "bound_ms": bound_32k, "bound_by": by_32k, "tflops": tflops_32k,
                 "max_abs_err": None, "sdpa_max_abs_diff": diff_32k})
    log(f"9 (a) K3 {shape_32k.name} B=1 H={h} S=T={s32}: device time {route_32k} route "
        f"{ms_32k:.3f} ms ({tflops_32k:.0f} TFLOP/s), tile route {tile_32k:.3f} ms, SDPA "
        f"{lib_32k:.3f} ms, bound {bound_32k:.3f} ms ({by_32k}); |K3 - SDPA| max {diff_32k:.3g} "
        f"(not gated); plain version skipped: its fp32 scores alone would take "
        f"{4 * h * s32 * s32 / 1e9:.0f} GB")
    del qh, kh, vh, out

    # (c) K6 at jamba's width, bitwise against its plain version.
    want = kscan.opope_chunked_scan_plain(decay, update)
    if not torch.equal(states, want):
        bad = (states != want).sum().item()
        raise AssertionError(f"K6 [{s_scan}, {n_state}]: {bad} states differ from the plain "
                             "version (bitwise gate)")
    del want
    ms_scan = time_ms(torch, lambda i: kscan.opope_chunked_scan(decay, update), 1)
    plain_scan = time_ms(torch, lambda i: kscan.opope_chunked_scan_plain(decay, update), 1,
                         iters=1, warmup=0)
    bound_scan = 1e3 * 3 * 4 * s_scan * n_state / HBM_BYTES_PER_S
    log(f"9 (c) K6 [{s_scan}, {n_state}] fp32: bitwise equal to the plain version; kernel "
        f"{ms_scan:.4f} ms, plain {plain_scan:.1f} ms, bound {bound_scan:.4f} ms (bytes)")
    del decay, update, states
    n_scan = 0
    for s, n in ((100, 1), (100, 3), (100, 100), (1, 5), (130, 4096)):
        for dts in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32)):
            a = (0.2 + 0.79 * torch.rand((s, n), generator=gen, device=dev)).to(dts[0])
            u = torch.randn((s, n), generator=gen, device=dev).to(dts[1])
            got = kscan.opope_chunked_scan(a, u, chunk=16)
            sync(torch, dev)
            if not (torch.equal(got, kscan.opope_chunked_scan_plain(a, u))
                    and torch.equal(got, kscan.opope_chunked_scan(a, u, chunk=64))):
                raise AssertionError(f"K6 coverage [{s}, {n}] {dts}: not bitwise")
            n_scan += 1
    log(f"9 (c) K6 coverage: {n_scan} ragged/dtype cases bitwise, chunk 16 = chunk 64")

    k3 = rows[0]
    k3_record = {
        "name": "opope_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_attention.cu",
        "replaces": "src/repro/kernels/opope_attention.py:118",
        "launches": launches["k3"],
        "launches_by_path": {"kernels entry point, chatglm3-6b attention width": launches["k3"]},
        "launches_by_route": k3_by_route,
        "max_abs_err": k3_err,
        "ms": k3["ms"],
        "ms_tile_route": k3["ms_tile_route"],
        "tflops": k3["tflops"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "model_attention_max_abs_err": model_err,
        "work": f"one causal prefill of chatglm3-6b's attention, B=4, H={h}, S=T=2048, D={d}, "
                "bf16, on the sm90 route (per-shape rows under 'shapes')",
        "timing": "ms, ms_tile_route and library_ms: device time by CUDA events around calls "
                  "queued behind a sleeping kernel (queued_ms); plain_ms: CUDA events around "
                  "the loop",
        "coverage_by_route": cov_routes,
        "build_s": kbuild.BUILD_SECONDS.get("opope_attention"),
        "shapes": rows,
    }
    k6_record = {
        "name": "opope_chunked_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_scan.cu",
        "replaces": "src/repro/kernels/opope_scan.py:65",
        "launches": launches["k6"],
        "launches_by_path": {"kernels entry point, jamba-v0.1 mamba scan width": launches["k6"]},
        "max_abs_err": 0.0,
        "ms": ms_scan,
        "plain_ms": plain_scan,
        "bound_ms": bound_scan,
        "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no single PyTorch call returns every state of a linear recurrence",
        "work": f"all {s_scan} states of {n_state} fp32 columns (jamba-v0.1's d_inner x d_state "
                "at train_4k)",
    }
    return k3_record, k6_record


def decode_profile(torch, step, step_ms, n_steps: int = 4, tag: str = "(d)"):
    """Device time by kernel over ``n_steps`` decode steps (torch.profiler),
    beside the steps' host wall time: the device's busy share (kernels run
    one at a time on the one stream) and the top kernels. Prints "not
    measured" and returns None when the trace holds no device time; else
    returns ``(key, ms per step, launches per step)`` rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    # Device-side events only: a CPU op's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count // n_steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        log(f"{tag} profiler: device time not measured (no device events in the trace)")
        return None
    log(f"{tag} profiled decode step: {wall_ms:.3f} ms host wall (unprofiled {step_ms:.3f} ms), "
        f"{busy_ms:.3f} ms device busy ({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"{tag}   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import epilogue as ep
    from repro_torch.kernels import ops
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.kernels import opope_grouped as k4mod
    from repro_torch.kernels import opope_scan as kscan
    from repro_torch.models import attention as mattn
    import torch.nn.functional as F
    from repro_torch import quant as qz
    from repro_torch.quant import backends as q8b
    from repro_torch.quant import opope_q8 as q8mod

    smi = nvidia_smi()
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s together; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(kbuild.BUILD_SECONDS.items())))
    for name, path in libs.items():
        entry = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                kernel = "sm90 " if "sm90" in entry else ""
                log(f"ptxas {name} {kernel}{entry[-60:]}: {line.strip()}")
                # K5's kernels are held to no spill.
                spilled = re.findall(r"(\d+) bytes spill", line)
                if name == "opope_q8_grouped" and any(int(x) for x in spilled):
                    raise AssertionError(f"ptxas: {entry} spills: {line.strip()}")

    cfg = get_config("chatglm3-6b")
    mcfg = get_config("deepseek-moe-16b")
    dev = torch.device("cuda")
    layer, rows, max_err = kernel_phase(torch, ep, cfg, mcfg, dev)
    res = model_phase(torch, np, cfg, ops, dev)

    # One layer's 7 GEMMs of a 4-slot decode step (and of a 512-row
    # prefill), from the timed rows.
    by_key = {(r["m"], r["k"], r["n"], r["epilogue"]): r for r in rows if r["model"] == cfg.name}
    layer_sums = {}
    for m in K1_MS:
        m_rows = [by_key[(m, k, n, ch)] for _, k, n, ch in layer]
        layer_sums[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "event_ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
        flops = sum(2 * m * n * k for _, k, n, _ in layer)
        log(f"K1 one chatglm3-6b layer at M={m}: sm90 {layer_sums[m]['ms']:.4f} ms device "
            f"({flops / layer_sums[m]['ms'] / 1e9:.1f} TFLOP/s; {layer_sums[m]['event_ms']:.4f} "
            f"ms by CUDA events, host issue included), tile route "
            f"{layer_sums[m]['tile_ms']:.4f} ms, torch.matmul {layer_sums[m]['library_ms']:.4f} ms, "
            f"bound {layer_sums[m]['bound_ms']:.4f} ms")
    sums = layer_sums[4]

    def layer_bound_by(m):
        t_bytes = sum(2 * (m * k + k * n + m * n * (1 + (ch != "none"))) for _, k, n, ch in layer)
        t_ops = sum(2 * m * n * k for _, k, n, _ in layer)
        return "bytes" if t_bytes / HBM_BYTES_PER_S >= t_ops / BF16_FLOPS else "operations"
    gemm_ms_step = cfg.n_layers * sums["ms"]
    log(f"(d) lockstep decode step, 4 rows: {res['decode_step_ms']:.3f} ms wall; its "
        f"{7 * cfg.n_layers} GEMMs take {gemm_ms_step:.3f} ms on the kernel "
        f"(cold-L2 timings above; bound {cfg.n_layers * sums['bound_ms']:.3f} ms)")
    # Phases 7 and 8 on chatglm3-6b's weights: the int8 kernels at both
    # models' shapes, then chatglm3-6b under mlp_q8_policy().
    q8_rows, q8_errs, k5_cov = q8_kernel_phase(torch, q8mod, qz, q8b, k4mod, ep, cfg, mcfg, dev)
    kernels = {"K1": opope_gemm, "K4": k4mod.opope_gemm_grouped,
               "K2": q8mod.opope_gemm_q8, "K5": q8mod.opope_gemm_q8_grouped}
    glm_q8 = q8_model_phase(
        torch, np, cfg, res.pop("params"), qz.mlp_q8_policy(),
        qz.PrecisionPolicy(rules={"mlp": "torch_q8", "moe": "torch_q8"}, default="torch"),
        {"K1": 4, "K2": 3}, ops, ep, kernels, dev, "8 chatglm3-6b q8")
    # Free chatglm3-6b before deepseek-moe-16b's 33 GB are drawn.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"allocated after chatglm3-6b: {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    ffn, g_rows, g_err, g_cov = grouped_phase(torch, k4mod, ops, ep, mcfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mres = moe_phase(torch, np, mcfg, ops, ep, k4mod, dev)
    ds_q8 = q8_model_phase(
        torch, np, mcfg, mres.pop("params"), qz.PrecisionPolicy(rules={"moe": "q8"}),
        qz.PrecisionPolicy(rules={"moe": "torch_q8"}, default="torch"),
        {"K1": 5, "K2": 3, "K5": 3}, ops, ep, kernels, dev, "8 deepseek-moe-16b q8")
    # Phase 9 after deepseek-moe-16b's weights are freed: K3 and K6.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"allocated after deepseek-moe-16b: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    k3_record, k6_record = attention_scan_phase(
        torch, F, kscan, mattn, cfg, get_config("jamba-v0.1-52b"),
        shape_by_name("prefill_32k"), dev)
    # One MoE layer's 3 grouped GEMMs of a 4-slot decode step (capacity 1).
    g_decode = [r for r in g_rows if r["m"] == 1]
    g_sums = {key: sum(r[key] for r in g_decode)
              for key in ("ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"(c) deepseek decode step: its {3 * mcfg.n_layers} grouped GEMMs take "
        f"{mcfg.n_layers * g_sums['ms']:.3f} ms on K4 (cold-L2 timings above; byte bound "
        f"{mcfg.n_layers * g_sums['bound_ms']:.3f} ms)")
    g_layers = {}
    for m in (1, 30, 60):
        m_rows = [r for r in g_rows if r["m"] == m]
        g_layers[m] = {key: sum(r[key] for r in m_rows)
                       for key in ("ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"K4 deepseek's 3 expert GEMMs (G {mcfg.moe.n_experts}) at M={m}: sm90 "
            f"{g_layers[m]['ms']:.4f} ms, tile route {g_layers[m]['tile_ms']:.4f} ms, torch.bmm "
            f"{g_layers[m]['library_ms']:.4f} ms, bound {g_layers[m]['bound_ms']:.4f} ms (bytes "
            f"{g_layers[m]['bound_ms'] / g_layers[m]['ms']:.1%} of the kernel's time)")

    k1_paths = {cfg.name: res["launches"], mcfg.name: mres["launches"]["k1"],
                f"{cfg.name} q8": glm_q8["launches"]["K1"],
                f"{mcfg.name} q8": ds_q8["launches"]["K1"]}
    record = {
        "name": "opope_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_gemm.cu",
        "replaces": "src/repro/kernels/opope_gemm.py:293",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        # check_routes held every path's launches to the sm90 route.
        "launches_by_route": {"sm90": sum(k1_paths.values()), "tile": 0},
        "max_abs_err": max_err,
        "ms": sums["ms"],
        "tile_ms": sums["tile_ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": layer_bound_by(4),
        "library_ms": sums["library_ms"],
        "work": "the 7 GEMMs of one chatglm3-6b layer in a 4-slot decode step on the sm90 "
                "route ('tile_ms': the same calls on the tile route; per-shape rows under "
                "'shapes'; the same layer at 64, 256 and 512 rows under 'layers')",
        "timing": "ms, tile_ms and library_ms: device time (CUDA events around calls queued "
                  "behind a sleeping kernel); event_ms and "
                  "plain_ms: CUDA events around the loop, the host's issue rate included",
        "layers": {str(m): v for m, v in layer_sums.items()},
        "prefill_layer": dict(layer_sums[512], m=512, bound_by=layer_bound_by(512)),
        "build_s": kbuild.BUILD_SECONDS.get("opope_gemm"),
        "decode_step_device_ms": {cfg.name: res["device_ms"],
                                  mcfg.name: mres["device_ms"]},
        "shapes": rows,
    }
    g_record = {
        "name": "opope_gemm_grouped",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_grouped.cu",
        "replaces": "src/repro/kernels/opope_grouped.py:228",
        "launches": mres["launches"]["k4"],
        "launches_by_path": {mcfg.name: mres["launches"]["k4"],
                             f"{mcfg.name} q8": ds_q8["launches"]["K4"]},
        # check_routes held both bf16 paths' launches to the sm90 route.
        "launches_by_route": {"sm90": mres["launches"]["k4"], "tile": 0},
        "coverage_launches_by_route": g_cov,
        "max_abs_err": g_err,
        "ms": g_sums["ms"],
        "tile_ms": g_sums["tile_ms"],
        "plain_ms": g_sums["plain_ms"],
        "bound_ms": g_sums["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in g_decode) else "operations",
        "library_ms": g_sums["library_ms"],
        "work": "the 3 grouped GEMMs (64 experts) of one deepseek-moe-16b layer in a 4-slot "
                "decode step on the sm90 route ('tile_ms': the same calls on the tile route; "
                "the same GEMMs at prefill capacities 30 and 60 under 'layers'; per-shape rows "
                "under 'shapes')",
        "timing": "ms, tile_ms and library_ms: device time (CUDA events around calls queued "
                  "behind a sleeping kernel); plain_ms: CUDA events around the loop, the "
                  "host's issue rate included",
        "layers": {str(m): v for m, v in g_layers.items()},
        "build_s": kbuild.BUILD_SECONDS.get("opope_grouped"),
        "decode_step_device_ms": mres["device_ms"],
        "routing_agreement": mres["routing_agreement"],
        "shapes": g_rows,
    }
    # K2: the 3 MLP GEMMs of one chatglm3-6b layer in a 4-slot decode step;
    # K5: the 3 expert GEMMs of one deepseek-moe-16b layer (capacity 1).
    q8_records = []
    for name, src_line, sel, paths, work, lib in (
            ("opope_gemm_q8", 243, lambda r: r["path"] == "chatglm3-6b mlp" and r["m"] == 4,
             {f"{cfg.name} q8": glm_q8["launches"]["K2"],
              f"{mcfg.name} q8": ds_q8["launches"]["K2"]},
             "the 3 MLP GEMMs of one chatglm3-6b layer in a 4-slot decode step",
             "torch._int_mm (M padded to 32 where M <= 16) plus the dequant multiply"),
            ("opope_gemm_q8_grouped", 451,
             lambda r: r["path"] == "deepseek-moe-16b experts" and r["m"] == 1,
             {f"{mcfg.name} q8": ds_q8["launches"]["K5"]},
             "the 3 grouped expert GEMMs (64 experts) of one deepseek-moe-16b layer in a "
             "4-slot decode step",
             "none: no single PyTorch call computes a grouped int8 GEMM")):
        sel_rows = [r for r in q8_rows if sel(r)]
        sums = {key: sum(r[key] for r in sel_rows)
                for key in ("ms", "plain_ms", "bound_ms", "weight_quant_ms")}
        q8_records.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "opope_q8_grouped.cu" if "grouped" in name else "opope_q8.cu"),
            "replaces": f"src/repro/quant/pallas_q8.py:{src_line}",
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": q8_errs["k5" if "grouped" in name else "k2"],
            "ms": sums["ms"],
            "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"],
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sel_rows) else "operations",
            "library_ms": (sum(r["library_ms"] for r in sel_rows) if "grouped" not in name
                           else None),
            "library": lib,
            "weight_quant_ms": sums["weight_quant_ms"],
            "work": work + " (per-shape rows of both models under 'shapes')",
            "decode_step_device_ms": (glm_q8 if "grouped" not in name else ds_q8)["device_ms"],
            "shapes": [r for r in q8_rows if (r["g"] > 0) == ("grouped" in name)],
        })
        log(f"{name}: {work}: kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
            f"bound {sums['bound_ms']:.4f} ms; per-call weight quantization of the same "
            f"weights {sums['weight_quant_ms']:.4f} ms")
    # K2's routes and its 512-row prefill layer, from the same timed rows.
    k2_paths = q8_records[0]["launches_by_path"]
    layers = {}
    for m in (4, 512):
        m_rows = [r for r in q8_rows if r["path"] == "chatglm3-6b mlp" and r["m"] == m]
        layers[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "tile_ms", "event_ms", "plain_ms", "library_ms", "library_event_ms",
            "bound_ms")}
        layers[m]["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in m_rows)
                                 else "operations")
        ops_m = sum(2 * r["m"] * r["n"] * r["k"] for r in m_rows)
        layers[m]["tops"] = ops_m / layers[m]["ms"] / 1e9
        log(f"K2 chatglm3-6b's 3 MLP GEMMs at M={m}: sm90 {layers[m]['ms']:.4f} ms device "
            f"({layers[m]['tops']:.1f} TOP/s), tile route {layers[m]['tile_ms']:.4f} ms, "
            f"torch._int_mm+dequant {layers[m]['library_ms']:.4f} ms device "
            f"({layers[m]['library_event_ms']:.4f} by CUDA events), bound "
            f"{layers[m]['bound_ms']:.4f} ms ({layers[m]['bound_by']})")
    q8_records[0].update(
        # check_routes held every path's launches to the sm90 route.
        launches_by_route={"sm90": sum(k2_paths.values()), "tile": 0},
        tile_ms=layers[4]["tile_ms"], event_ms=layers[4]["event_ms"],
        library_event_ms=layers[4]["library_event_ms"],
        prefill_layer=dict(layers[512], m=512),
        timing="ms, tile_ms and library_ms: device time (CUDA events around calls queued "
               "behind a sleeping kernel); event_ms, library_event_ms and plain_ms: CUDA "
               "events around the loop, the host's issue rate included",
        build_s=kbuild.BUILD_SECONDS.get("opope_q8"))
    # K5's routes at the decode capacity and at prefill capacities 30 and 60,
    # beside K4's sm90 route on the same shapes in bf16, from the same rows.
    k5_layers = {}
    for m in (1, 30, 60):
        m_rows = [r for r in q8_rows if r["path"] == "deepseek-moe-16b experts" and r["m"] == m]
        k5_layers[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "tile_ms", "event_ms", "k4_sm90_ms", "plain_ms", "bound_ms")}
        k5_layers[m]["tile_rows"] = m_rows[0]["tile_rows"]
        log(f"K5 deepseek's 3 expert GEMMs (G {mcfg.moe.n_experts}) at M={m}: sm90 "
            f"{k5_layers[m]['ms']:.4f} ms device ({k5_layers[m]['tile_rows']} rows; "
            f"{k5_layers[m]['event_ms']:.4f} ms by CUDA events), tile route "
            f"{k5_layers[m]['tile_ms']:.4f} ms, K4 sm90 (bf16) {k5_layers[m]['k4_sm90_ms']:.4f} "
            f"ms, bound {k5_layers[m]['bound_ms']:.4f} ms (bytes "
            f"{k5_layers[m]['bound_ms'] / k5_layers[m]['ms']:.1%} of the kernel's time)")
    k5_paths = q8_records[1]["launches_by_path"]
    q8_records[1].update(
        # check_routes held the path's launches to the sm90 route.
        launches_by_route={"sm90": sum(k5_paths.values()), "tile": 0},
        coverage_launches_by_route=k5_cov,
        tile_ms=k5_layers[1]["tile_ms"], event_ms=k5_layers[1]["event_ms"],
        k4_sm90_ms=k5_layers[1]["k4_sm90_ms"],
        layers={str(m): v for m, v in k5_layers.items()},
        timing="ms, tile_ms and k4_sm90_ms (K4's sm90 route on the same shapes in bf16): "
               "device time (CUDA events around calls queued behind a sleeping kernel); "
               "event_ms and plain_ms: CUDA events around the loop, the host's issue "
               "rate included",
        build_s=kbuild.BUILD_SECONDS.get("opope_q8_grouped"))
    for tag, r in (("chatglm3-6b q8", glm_q8), ("deepseek-moe-16b q8", ds_q8)):
        log(f"{tag}: prefill logits kernels vs plain RMS {r['logits_rms']:.4g} (floor "
            f"{r['logits_floor_rms']:.4g}); q8 vs bf16 RMS {r['q8_vs_bf16']['rms']:.4g}; "
            f"decode step {r['decode_step_ms']:.3f} ms wall")
    print(smi, flush=True)
    print(json.dumps({"kernels": [record, g_record] + q8_records + [k3_record, k6_record]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
