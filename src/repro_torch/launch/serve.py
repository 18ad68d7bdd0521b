"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

* ``--engine continuous`` (default): the continuous-batching engine over a
  Poisson-ish arrival trace; requests join and leave mid-flight.
* ``--engine static``: the lockstep ``ServeEngine``; one batch enters and
  exits together.

Runs on ``--device cuda`` (default) or ``cpu``. Parameters are random, drawn
from ``--seed``. ``--reduced`` serves the tiny same-family config.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.transformer import param_dtype
from repro_torch.serve import ContinuousEngine, ServeEngine, gen_len_spread, poisson_trace


def _static(cfg, params, device, args) -> dict:
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    ).to(device)
    eng = ServeEngine(
        cfg=cfg, params=params, max_len=args.prompt_len + args.gen,
        cache_dtype=param_dtype(cfg), temperature=args.temperature,
    )
    t0 = time.perf_counter()
    toks = eng.generate(
        {"tokens": tokens}, args.gen,
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
        max_len=args.prompt_len + args.gen, cache_dtype=param_dtype(cfg),
        temperature=args.temperature,
    )
    report = eng.timed_serve(
        trace, generator=torch.Generator(device=device).manual_seed(args.seed)
    )
    return {
        "engine": "continuous", "requests": len(trace),
        "tokens": report.generated_tokens, "wall_s": report.wall_time_s,
        "tokens_per_sec": report.tokens_per_sec,
        "decode_steps": report.decode_steps,
        "prefill_batches": report.prefill_batches,
        "mean_occupancy": report.mean_occupancy,
        "ttft_p50_s": report.ttft_p50, "ttft_p99_s": report.ttft_p99,
        "itl_p50_s": report.itl_p50, "itl_p99_s": report.itl_p99,
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = api.resolve_device(args.device)
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device
    )
    run = _static if args.engine == "static" else _continuous
    out = {"arch": cfg.name, "device": str(device), **run(cfg, params, device, args)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
