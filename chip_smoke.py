#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, started together);
3. the O-POPE GEMM kernel against its plain PyTorch version on the card, at
   the main path's shapes and chains (timed beside ``torch.matmul`` and the
   card's bound) and at small ragged shapes for every epilogue op;
4. full-width chatglm3-6b (28 layers, bf16, random weights from seed 0):
   (a) prefill logits through the kernel against the plain backend,
   (b) the continuous-batching engine on a Poisson trace — the main path,
       whose kernel launches are counted — (c) the lockstep engine, and
   (d) a lockstep decode step's wall time beside its GEMM kernel time.

The last lines are a JSON ``{"kernels": [...]}`` record and then
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and no result is printed. Without a CUDA device, or outside a checkout,
it exits with code 2.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2**20


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


def ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at the magnitude of ``x``."""
    mant = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - mant)


def check_close(torch, kmod, out, a, b, c, out_dtype, steps, ops_, what):
    """Kernel output against the plain version on the same inputs:
    fp32 within rtol 1e-4 / atol 1e-3 (only the order of sums differs);
    bf16/fp16 within one ulp of the plain fp32 result, plus 1e-5 of its
    largest magnitude for sum-order noise where the result nearly cancels;
    int8 within 1 (a rounding boundary may fall between two sum orders).
    Returns the largest absolute difference."""
    if out_dtype == torch.int8:
        ref = kmod.opope_gemm_plain(a, b, c, out_dtype=torch.int8, epilogue=steps,
                                    epilogue_operands=ops_)
        err = (out.int() - ref.int()).abs().max().item() if out.numel() else 0
        if err > 1:
            raise AssertionError(f"{what}: int8 off by {err}")
        return float(err)
    ref = kmod.opope_gemm_plain(a, b, c, out_dtype=torch.float32, epilogue=steps,
                                epilogue_operands=ops_)
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


def gemm_bound(m, k, n, n_full_operands, elem=2):
    """Least time in ms of one GEMM on the card, and what bounds it: A, B
    and the output moved once each plus the epilogue's full operands, or
    2MNK at the bf16 tensor-core rate."""
    nbytes = elem * (m * k + k * n + m * n * (1 + n_full_operands))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, kmod, ep, cfg, dev):
    """Phase 3. Returns the layer's GEMMs, the per-shape timing rows and the
    largest error."""
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
    max_err = 0.0
    # Correctness at the main path's shapes, every chain it uses.
    for m in (4, 512):
        for kk, n in sorted({(k, n) for _, k, n, _ in layer}):
            a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
            b = (torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
            for chain in chains:
                steps, ops_ = operands(m, n, chain, torch.bfloat16)
                out = kmod.opope_gemm(a, b, None, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                err = check_close(torch, kmod, out, a, b, None, torch.bfloat16, steps, ops_,
                                  f"main M={m} K={kk} N={n} {chain}")
                max_err = max(max_err, err)
                log(f"check main-path M={m} K={kk} N={n} chain={chain}: max_abs_err={err:.3g} ok")

    # Timing at the main path's (shape, chain) pairs, weights cold in L2.
    rows = []
    for m in (4, 512):
        for kk, n, chain in sorted({(k, n, ch) for _, k, n, ch in layer}):
            steps, ops_ = operands(m, n, chain, torch.bfloat16)
            b_bytes = kk * n * 2
            n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / b_bytes)))
            a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
            bs = [(torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
                  for _ in range(n_bufs)]
            ms = time_ms(torch, lambda i: kmod.opope_gemm(
                a, bs[i], None, epilogue=steps, epilogue_operands=ops_), n_bufs)
            plain_ms = time_ms(torch, lambda i: kmod.opope_gemm_plain(
                a, bs[i], None, epilogue=steps, epilogue_operands=ops_), n_bufs)
            lib_ms = time_ms(torch, lambda i: torch.matmul(a, bs[i]), n_bufs)
            bound_ms, bound_by = gemm_bound(m, kk, n, len(ops_))
            out = kmod.opope_gemm(a, bs[0], None, epilogue=steps, epilogue_operands=ops_)
            err = check_close(torch, kmod, out, a, bs[0], None, torch.bfloat16, steps, ops_,
                              f"timed M={m} K={kk} N={n} {chain}")
            max_err = max(max_err, err)
            row = {"m": m, "k": kk, "n": n, "epilogue": chain, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": err}
            rows.append(row)
            log(f"time M={m} K={kk} N={n} chain={chain}: kernel {ms:.4f} ms, "
                f"torch.matmul {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3g}")
    del bs

    # Coverage: ragged shapes, fp32 and bf16 in, both C forms, every op.
    n_cov = 0
    for m, kk, n in ((5, 40, 24), (130, 300, 200), (64, 128, 192)):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn((m, kk), generator=gen, device=dev).to(dt)
            b = torch.randn((kk, n), generator=gen, device=dev).to(dt)
            cs = {"none": None,
                  "row": torch.randn((n,), generator=gen, device=dev).to(dt),
                  "full": torch.randn((m, n), generator=gen, device=dev).to(dt)}
            row_op = torch.randn((1, n), generator=gen, device=dev)
            full_op = torch.randn((m, n), generator=gen, device=dev).to(dt)
            for c_name, c in cs.items():
                acc_max = kmod.opope_gemm_plain(a, b, c, out_dtype=torch.float32).abs().max()
                scalar = (acc_max / 100.0).reshape(1, 1)
                for name in ep.epilogue_ops():
                    kind = ep.op_kind(name)
                    ops_ = {"none": (), "row": (row_op,), "full": (full_op,),
                            "scalar": (scalar,)}[kind]
                    out_dtype = torch.int8 if name == "requant_int8" else dt
                    out = kmod.opope_gemm(a, b, c, out_dtype=out_dtype, epilogue=(name,),
                                          epilogue_operands=ops_)
                    sync(torch, dev)
                    check_close(torch, kmod, out, a, b, c, out_dtype, (name,), ops_,
                                f"coverage {m}x{kk}x{n} {dt} C={c_name} {name}")
                    n_cov += 1
            # One long chain, fp16 out, and the requant chain into int8.
            chain = ("gelu", "scale", "residual", "mul", "relu", "bias")
            ops_ = (row_op, full_op, full_op, row_op)
            for out_dtype in (torch.float16, dt):
                out = kmod.opope_gemm(a, b, cs["row"], out_dtype=out_dtype, epilogue=chain,
                                      epilogue_operands=ops_)
                sync(torch, dev)
                check_close(torch, kmod, out, a, b, cs["row"], out_dtype, chain, ops_,
                            f"coverage chain {m}x{kk}x{n} {dt} -> {out_dtype}")
                n_cov += 1
            chain = ("silu", "mul", "requant_int8")
            acc_max = kmod.opope_gemm_plain(a, b, out_dtype=torch.float32).abs().max()
            ops_ = (full_op, (acc_max / 50.0).reshape(1, 1))
            out = kmod.opope_gemm(a, b, out_dtype=torch.int8, epilogue=chain,
                                  epilogue_operands=ops_)
            sync(torch, dev)
            check_close(torch, kmod, out, a, b, None, torch.int8, chain, ops_,
                        f"coverage requant chain {m}x{kk}x{n} {dt}")
            n_cov += 1
    log(f"coverage: {n_cov} ragged/dtype/C/epilogue cases within tolerance")
    return layer, rows, max_err


def model_phase(torch, np, cfg, ops, kmod, dev):
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
    kmod.opope_gemm.launches = 0
    report = eng.timed_serve(trace)
    launches = kmod.opope_gemm.launches
    want = per_forward * (report.decode_steps + report.prefill_batches)
    if launches != want or ops.backend("torch").calls != 0:
        raise AssertionError(f"kernel launches {launches} != {want} (torch calls "
                             f"{ops.backend('torch').calls})")
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {r.rid}: bad output {out}")
    log(f"(b) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, "
        f"mean_occupancy {report.mean_occupancy:.3f}, wall {report.wall_time_s:.3f} s, "
        f"{report.tokens_per_sec:.1f} tokens/s, TTFT p50 {report.ttft_p50 * 1e3:.1f} ms, "
        f"ITL p50 {report.itl_p50 * 1e3:.1f} ms, kernel launches {launches} "
        f"= 7 * {cfg.n_layers} * ({report.decode_steps} + {report.prefill_batches})")

    # (c) the lockstep engine.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    kmod.opope_gemm.launches = 0
    t0 = time.perf_counter()
    toks = ServeEngine(cfg=cfg, params=params, max_len=80).generate({"tokens": prompts}, 16)
    toks_host = toks.cpu()
    dt = time.perf_counter() - t0
    if tuple(toks_host.shape) != (4, 16) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"static engine output {tuple(toks_host.shape)}")
    if kmod.opope_gemm.launches != per_forward * 16:
        raise AssertionError(f"static launches {kmod.opope_gemm.launches} != {per_forward * 16}")
    log(f"(c) static: 4 x 64-token prompts, 16 tokens each in {dt:.3f} s "
        f"({64 / dt:.1f} tokens/s), kernel launches {kmod.opope_gemm.launches}")

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
        if dev.type == "cuda":
            decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 83 + i), step_ms)
    return {"continuous": report, "launches": launches, "decode_step_ms": step_ms}


def decode_profile(torch, step, step_ms, n_steps: int = 4) -> None:
    """Device time by kernel over ``n_steps`` decode steps (torch.profiler),
    beside the steps' host wall time: the device's busy share (kernels run
    one at a time on the one stream) and the top kernels. Prints "not
    measured" when the trace holds no device time."""
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
        log("(d) profiler: device time not measured (no device events in the trace)")
        return
    log(f"(d) profiled decode step: {wall_ms:.3f} ms host wall (unprofiled {step_ms:.3f} ms), "
        f"{busy_ms:.3f} ms device busy ({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"(d)   {ms:8.3f} ms  x{count:<4d} {key[:90]}")


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

    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import epilogue as ep
    from repro_torch.kernels import ops
    from repro_torch.kernels import opope_gemm as kmod

    smi = nvidia_smi()
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    cfg = get_config("chatglm3-6b")
    dev = torch.device("cuda")
    layer, rows, max_err = kernel_phase(torch, kmod, ep, cfg, dev)
    res = model_phase(torch, np, cfg, ops, kmod, dev)

    # One layer's 7 GEMMs of a 4-slot decode step, from the timed rows.
    by_key = {(r["m"], r["k"], r["n"], r["epilogue"]): r for r in rows}
    decode_rows = [by_key[(4, k, n, ch)] for _, k, n, ch in layer]
    sums = {key: sum(r[key] for r in decode_rows)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(2 * (4 * k + k * n + 4 * n * (1 + (ch != "none"))) for _, k, n, ch in layer)
    t_ops = sum(2 * 4 * n * k for _, k, n, _ in layer)
    gemm_ms_step = cfg.n_layers * sums["ms"]
    log(f"(d) lockstep decode step, 4 rows: {res['decode_step_ms']:.3f} ms wall; its "
        f"{7 * cfg.n_layers} GEMMs take {gemm_ms_step:.3f} ms on the kernel "
        f"(cold-L2 timings above; bound {cfg.n_layers * sums['bound_ms']:.3f} ms)")
    record = {
        "name": "opope_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_gemm.cu",
        "replaces": "src/repro/kernels/opope_gemm.py:293",
        "launches": res["launches"],
        "max_abs_err": max_err,
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": "bytes" if t_bytes / HBM_BYTES_PER_S >= t_ops / BF16_FLOPS else "operations",
        "library_ms": sums["library_ms"],
        "work": "the 7 GEMMs of one chatglm3-6b layer in a 4-slot decode step "
                "(per-shape rows under 'shapes')",
        "shapes": rows,
    }
    print(smi, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
