"""How often torch.profiler loses the markers that cut a session's runs apart.

``chip_smoke.py`` phase 4(h) profiles two runs (telemetry on, then off) in
one session and cuts the trace apart at marker kernels. This probe repeats
such sessions and reports, for each, what the trace kept of the markers,
in two schemes:

* ``old``: every marker an int16 fill (64 padding the session's start,
  one before each run and one after the last), the session stopped right
  after the last one; the runs cut at the last ``runs + 1`` fills.
* ``new``: the cuts are complex64 fills, another kernel than the
  padding's, and the session ends on a synchronize after the last cut
  (what ``chip_smoke._device_traces`` does).

Workloads: ``small`` (each run ``--kernels`` tiny kernels and a
synchronize) and ``serve`` (4(h)'s pair: chatglm3-6b at its published
width, random weights from seed 0, serving 4(b)'s Poisson trace on a fresh
``ContinuousEngine`` with telemetry on and then off).

Needs a CUDA device. Run from the root of a checkout, the port on the path::

    PYTHONPATH=src python tools/trace_cut_probe.py --workload small --sessions 100
    PYTHONPATH=src python tools/trace_cut_probe.py --workload serve --sessions 4

It prints one JSON line a session and a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def session(torch, fns, scheme):
    """One profiler session over ``fns``; what the trace kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def fill(dtype):
        torch.full((1,), 7, dtype=dtype, device="cuda")

    cut_dtype = torch.int16 if scheme == "old" else torch.complex64
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            fill(torch.int16)
        torch.cuda.synchronize()
        for fn in fns:
            fill(cut_dtype)
            fn()
            torch.cuda.synchronize()
        fill(cut_dtype)
        if scheme == "new":
            torch.cuda.synchronize()
    device = sorted((e.correlation_id(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    pads = [c for c, n in device if "FillFunctor<short>" in n]
    if scheme == "old":
        cuts = pads[-(len(fns) + 1):]
        pads = pads[:-(len(fns) + 1)]
        last_cut_kept = bool(device) and "FillFunctor<short>" in device[-1][1]
    else:
        cuts = [c for c, n in device if "FillFunctor<c10::complex" in n]
        last_cut_kept = bool(device) and "FillFunctor<c10::complex" in device[-1][1]
    windows = ([sum(cuts[i] < c < cuts[i + 1] for c, _ in device) for i in range(len(fns))]
               if len(cuts) == len(fns) + 1 else None)
    return {"scheme": scheme, "device_events": len(device), "pads_kept": len(pads),
            "cuts_kept": len(cuts), "last_cut_kept": last_cut_kept, "run_events": windows}


def small_fns(torch, n_kernels):
    x = torch.ones(256, device="cuda")

    def run():
        for _ in range(n_kernels):
            x.mul_(1.0)
    return [run, run]


def serve_fns(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import ContinuousEngine, poisson_trace

    cfg = get_config("chatglm3-6b")
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    def serve(flag):
        prev = obs_metrics.set_enabled(flag)
        try:
            eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
            eng.serve(poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                                    gen_lens=(8, 16, 32)))
        finally:
            obs_metrics.set_enabled(prev)

    serve(True)  # warm: the engine's first dispatches capture
    return [lambda: serve(True), lambda: serve(False)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("small", "serve"), default="small")
    ap.add_argument("--schemes", default="old,new")
    ap.add_argument("--sessions", type=int, default=20, help="sessions per scheme")
    ap.add_argument("--kernels", type=int, default=2000, help="kernels a run (small)")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_cut_probe: no CUDA device", file=sys.stderr)
        return 2
    fns = small_fns(torch, args.kernels) if args.workload == "small" else serve_fns(torch)
    summary = {}
    for scheme in args.schemes.split(","):
        lost = 0
        t0 = time.perf_counter()
        for i in range(args.sessions):
            rec = session(torch, fns, scheme)
            lost += rec["cuts_kept"] != len(fns) + 1 or not rec["last_cut_kept"]
            print(json.dumps({"label": args.label, "workload": args.workload, "session": i,
                              **rec}), flush=True)
        summary[scheme] = {"sessions": args.sessions, "sessions_losing_a_cut": lost,
                           "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps({"label": args.label, "workload": args.workload,
                      "device": torch.cuda.get_device_name(0), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
