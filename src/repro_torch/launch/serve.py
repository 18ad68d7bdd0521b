"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

* ``--engine continuous`` (default): the continuous-batching engine over a
  Poisson-ish arrival trace; requests join and leave mid-flight.
* ``--engine static``: the lockstep ``ServeEngine``; one batch enters and
  exits together. The vlm and audio families are served only here (their
  image rows or audio frames do not fit a token-prompt request): asked for
  the continuous engine, they fall back to this one with an
  ``engine_fallback`` log line. Their ``patch_embeds`` or ``frames`` are
  drawn from ``--seed`` in the parameters' dtype.

Runs on ``--device cuda`` (default) or ``cpu``. Parameters are random, drawn
from ``--seed``. ``--reduced`` serves the tiny same-family config.
``--kv-format`` narrows the continuous engine's K/V pool to int8 or fp8;
``REPRO_PREFILL_CHUNK=<power of two>`` turns on chunked prefill and
``REPRO_PREFIX_CACHE=1`` the prefix cache (with chunks of 32 unless set).
``REPRO_SLO_TTFT_MS`` / ``REPRO_SLO_ITL_MS`` set the SLOs the report's
goodput is measured against (there are no flags for them).

The run's result is one JSON line on stdout; progress lines go through the
structured logger (``REPRO_LOG=text|json``). ``REPRO_METRICS_PORT=<port>``
starts the scrape server (``/metrics``, ``/requests``, ``/trace`` on
127.0.0.1; 0 picks a free port), and ``--linger-seconds`` keeps the process
and that server alive after the run so the final state can be fetched.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.transformer import param_dtype
from repro_torch.serve import ContinuousEngine, ServeEngine, gen_len_spread, poisson_trace


def cache_dtype(cfg) -> torch.dtype:
    """The K/V cache's dtype, the reference launcher's rule: fp32 for an
    fp32 model, bf16 for every other (an fp16 model included)."""
    return torch.float32 if param_dtype(cfg) == torch.float32 else torch.bfloat16


def static_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """A static-engine batch drawn from ``seed`` with numpy, in
    :func:`api.input_specs`' layout: ``tokens`` [batch, prompt_len] and,
    for a vlm or audio model, standard-normal ``patch_embeds`` or
    ``frames`` in the parameters' dtype."""
    rng = np.random.default_rng(seed)
    out = {}
    specs = api.input_specs(cfg, batch=batch, seq=cfg.n_img_tokens + prompt_len,
                            kind="prefill")
    for key, spec in specs.items():
        if spec.is_floating_point():
            x = torch.from_numpy(rng.standard_normal(tuple(spec.shape), dtype=np.float32))
            out[key] = x.to(device=device, dtype=param_dtype(cfg))
        else:
            out[key] = torch.from_numpy(rng.integers(0, cfg.vocab, tuple(spec.shape))).to(device)
    return out


def _static(cfg, params, device, args) -> dict:
    eng = ServeEngine(
        cfg=cfg, params=params, max_len=cfg.n_img_tokens + args.prompt_len + args.gen,
        cache_dtype=cache_dtype(cfg), temperature=args.temperature,
    )
    batch = static_batch(cfg, args.batch, args.prompt_len, args.seed, device)
    t0 = time.perf_counter()
    toks = eng.generate(
        batch, args.gen,
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )
    first = toks[0].tolist()  # host fetch: the device has finished
    dt = time.perf_counter() - t0
    return {
        "engine": "static", "shape": list(toks.shape), "wall_s": dt,
        "tokens_per_sec": args.batch * args.gen / dt, "first_sequence": first,
    }


def _continuous(cfg, params, device, args) -> dict:
    trace = poisson_trace(
        args.n_requests, seed=args.seed, vocab=cfg.vocab,
        prompt_lens=(args.prompt_len // 4 or 1, args.prompt_len // 2 or 1,
                     args.prompt_len),
        gen_lens=gen_len_spread(args.gen), mean_interarrival=args.rate,
    )
    eng = ContinuousEngine(
        cfg=cfg, params=params, n_slots=args.slots,
        max_len=args.prompt_len + args.gen, cache_dtype=cache_dtype(cfg),
        temperature=args.temperature, kv_format=args.kv_format,
    )
    report = eng.timed_serve(
        trace, generator=torch.Generator(device=device).manual_seed(args.seed)
    )
    log = obs.get_logger("serve")
    log.info("phases", queue_p50_s=report.queue_p50, queue_p99_s=report.queue_p99,
             attach_p50_s=report.attach_p50, chunk_prefill_p50_s=report.chunk_prefill_p50,
             slot_hwm=report.slot_hwm)
    if report.goodput is not None:
        log.info("goodput", fraction=report.goodput)
    return {
        "engine": "continuous", "requests": len(trace),
        "tokens": report.generated_tokens, "wall_s": report.wall_time_s,
        "tokens_per_sec": report.tokens_per_sec,
        "decode_steps": report.decode_steps,
        "prefill_batches": report.prefill_batches,
        "mean_occupancy": report.mean_occupancy,
        "ttft_p50_s": report.ttft_p50, "ttft_p99_s": report.ttft_p99,
        "itl_p50_s": report.itl_p50, "itl_p99_s": report.itl_p99,
        "queue_p50_s": report.queue_p50, "queue_p99_s": report.queue_p99,
        "attach_p50_s": report.attach_p50, "attach_p99_s": report.attach_p99,
        "chunk_prefill_p50_s": report.chunk_prefill_p50,
        "chunk_prefill_p99_s": report.chunk_prefill_p99,
        "goodput": report.goodput, "slot_hwm": report.slot_hwm,
        "kv_format": args.kv_format, "kv_bytes_per_slot": report.kv_bytes_per_slot,
        "prefill_chunk": eng.prefill_chunk, "prefix_cache": eng.prefix_cache_stats(),
        "first_request_output": report.outputs[trace[0].rid],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4, help="static engine: batch size")
    ap.add_argument("--slots", type=int, default=4, help="continuous engine: slot pool size")
    ap.add_argument("--n-requests", type=int, default=12, help="continuous engine: trace length")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="continuous engine: mean interarrival (decode steps)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-format", default=None, choices=(None, "int8", "fp8_e4m3", "fp8_e5m2"),
                    help="continuous engine: narrow K/V lanes (half the bf16 pool's bytes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--linger-seconds", type=float, default=0.0,
                    help="keep the process (and its REPRO_METRICS_PORT scrape server) alive "
                    "this long after the run, so /metrics, /requests and /trace can be "
                    "fetched from the final registry (SIGINT ends the linger early)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = api.resolve_device(args.device)
    log = obs.get_logger("serve")
    server = obs.http.maybe_serve_from_env()
    if server is not None:
        log.info("metrics_server", port=server.port, endpoints="/metrics /requests /trace")
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device
    )
    run = _static if args.engine == "static" else _continuous
    if args.engine == "continuous" and not api.takes_token_prompt(cfg):
        log.info("engine_fallback", family=cfg.family, engine="static")
        run = _static
    out = {"arch": cfg.name, "device": str(device), **run(cfg, params, device, args)}
    print(json.dumps(out), flush=True)
    if args.linger_seconds > 0 and server is not None:
        # Nothing changes the registry any more: /metrics now serves what
        # REPRO_METRICS_DUMP writes at exit.
        log.info("metrics_linger", port=server.port, seconds=args.linger_seconds)
        try:
            time.sleep(args.linger_seconds)
        except KeyboardInterrupt:
            pass
    return out


if __name__ == "__main__":
    main()
