"""``python -m repro_torch.launch.stats``: surface the port's telemetry
(see :mod:`repro_torch.obs`).

The port of :mod:`repro.launch.stats`. Metrics live in-process, so the CLI
has two modes of access:

* **post-mortem** — read artifacts another run wrote: a snapshot JSON
  (``REPRO_METRICS_DUMP=snap.json`` makes any instrumented process dump one
  at exit), the JSONL event log (``REPRO_EVENTS=events.jsonl``) or a raw
  trace dump (``REPRO_TRACE_DUMP=raw.json``).
* **in-process** — run the serving or the training launcher inside this
  process and report its registry when it finishes, optionally under
  ``torch.profiler`` with its Chrome trace exported.

Examples::

    # pretty-print / export a snapshot another run dumped
    python -m repro_torch.launch.stats snapshot --file snap.json
    python -m repro_torch.launch.stats snapshot --file snap.json --prom

    # tail the event log a serving process is appending to
    python -m repro_torch.launch.stats tail --file events.jsonl -n 20
    python -m repro_torch.launch.stats tail --file events.jsonl --follow

    # export the request-lifecycle trace as Chrome trace-event JSON
    python -m repro_torch.launch.stats trace --file raw.json --out timeline.json
    python -m repro_torch.launch.stats trace --file raw.json --summary

    # run the serving driver here, then report (optionally with a profile)
    python -m repro_torch.launch.stats serve --profile /tmp/prof -- \\
        --arch chatglm3-6b --reduced --device cpu

    # run the training launcher here, then report
    python -m repro_torch.launch.stats train -- \\
        --arch chatglm3-6b --reduced --device cpu --steps 20

    # rank GEMM shape buckets by attributed host wall time and utilization gap
    python -m repro_torch.launch.stats top --file snap.json -n 10

The reference's ``bench`` (its history gate) waits for the port's
benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List, Optional

from repro_torch import obs

__all__ = ["main"]


def _fmt(v, width: int = 0) -> str:
    """``None``-safe number rendering ("n/a": no data is not a zero)."""
    s = "n/a" if v is None else f"{v:.4g}"
    return s.rjust(width) if width else s


def _print_snapshot(snap: Dict, *, prom: bool = False, as_json: bool = False,
                    out=None) -> None:
    out = out if out is not None else sys.stdout
    if prom:
        out.write(obs.prometheus_text(snap))
        return
    if as_json:
        json.dump(snap, out, indent=2)
        out.write("\n")
        return
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    hists = snap.get("histograms", {})
    if not (counters or gauges or hists):
        print("(empty registry)", file=out)
        return
    if counters:
        print("counters:", file=out)
        for name, fam in counters.items():
            for labels, v in fam.items():
                tag = f"{{{labels}}}" if labels else ""
                print(f"  {name}{tag} = {v:g}", file=out)
    if gauges:
        print("gauges:", file=out)
        for name, fam in gauges.items():
            for labels, v in fam.items():
                tag = f"{{{labels}}}" if labels else ""
                print(f"  {name}{tag} = {v:g}", file=out)
    if hists:
        print("histograms:", file=out)
        for name, fam in hists.items():
            for labels, h in fam.items():
                tag = f"{{{labels}}}" if labels else ""
                # Percentiles are None on an empty histogram, and only a
                # trailing window once the sample reservoir has evicted
                # (snapshot's percentile_mode) — say so instead of printing
                # a confident exact-looking number.
                win = ""
                if h.get("percentile_mode") == "windowed":
                    dropped = h.get("samples_dropped", 0)
                    win = f" [windowed: {dropped} dropped]"
                print(
                    f"  {name}{tag}: n={h['count']} mean={h['mean']:.6g} "
                    f"p50={_fmt(h['p50'])} p99={_fmt(h['p99'])} "
                    f"min={h['min']:.6g} max={h['max']:.6g}{win}",
                    file=out,
                )


def _load_snapshot(path: Optional[str]) -> Dict:
    if path is None:
        return obs.snapshot()
    with open(path) as f:
        return json.load(f)


def _cmd_snapshot(args) -> None:
    snap = _load_snapshot(args.file)
    _print_snapshot(snap, prom=args.prom, as_json=args.json)


def _cmd_tail(args) -> None:
    path = args.file or obs.event_log_path()
    if path is None:
        raise SystemExit(
            "no event log: pass --file or set REPRO_EVENTS=<path> on the "
            "producing process"
        )
    try:
        events = obs.read_events(path, n=None)
    except FileNotFoundError:
        # An instrumented run that emitted no events never creates the sink;
        # an empty tail is a state worth reporting, not a crash.
        print(f"no events recorded at {path}")
        return
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    for e in events[-args.n:]:
        print(json.dumps(e, default=str))
    if getattr(args, "follow", False):
        try:
            for e in obs.follow_events(
                path, poll_interval=args.poll, start_at_end=True
            ):
                if args.kind and e.get("kind") != args.kind:
                    continue
                print(json.dumps(e, default=str), flush=True)
        except KeyboardInterrupt:
            return


def _cmd_trace(args) -> None:
    """Export the request-lifecycle buffer as Chrome trace-event JSON."""
    from repro_torch.obs import tracing

    if args.file:
        with open(args.file) as f:
            snap = json.load(f)
    else:
        snap = tracing.snapshot()
    if not snap.get("requests"):
        print("no requests traced — run a continuous-engine workload with "
              "REPRO_METRICS=1 (and REPRO_TRACE_DUMP=<path> to export "
              "across processes)", file=sys.stderr)
    if args.summary:
        print(f"{'uid':>5} {'rid':>5} {'slot':>4} {'reason':<8} "
              f"{'queue_ms':>9} {'attach_ms':>9} {'chunk_ms':>9} "
              f"{'decode_ms':>9} {'total_ms':>9}")
        for req in snap.get("requests", []):
            by = {}
            for p in req.get("phases", []):
                if p.get("t1") is not None:
                    by[p["name"]] = by.get(p["name"], 0.0) + (p["t1"] - p["t0"])
            total = sum(by.values())
            print(f"{req['uid']:>5} {req['rid']:>5} "
                  f"{'-' if req.get('slot') is None else req['slot']:>4} "
                  f"{req.get('retire_reason') or 'live':<8} "
                  f"{by.get('queue', 0.0) * 1e3:>9.3f} "
                  f"{by.get('prefix_attach', 0.0) * 1e3:>9.3f} "
                  f"{(by.get('chunk_prefill', 0.0) + by.get('prefill', 0.0)) * 1e3:>9.3f} "
                  f"{by.get('decode', 0.0) * 1e3:>9.3f} {total * 1e3:>9.3f}")
        return
    doc = tracing.chrome_trace(snap)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
        n = sum(1 for e in doc["traceEvents"] if e.get("ph") == "b")
        print(f"[stats] {n} request span(s) -> {args.out} "
              f"(load in Perfetto / chrome://tracing)", file=sys.stderr)
    else:
        json.dump(doc, sys.stdout)
        sys.stdout.write("\n")


def _cmd_top(args) -> None:
    """Rank GEMM shape buckets by attributed time + utilization gap.

    Joins the ``gemm.device_seconds`` counters with the
    ``gemm.roofline_fraction`` histograms (both written by
    ``repro_torch.obs.attr`` during any serving run) on their shared label
    set. The gap column is ``1 - mean fraction``: how far the bucket
    runs below the roofline bound it was costed against.

    The names are the reference's, but on the port the seconds are not a
    device measurement: they are the host wall time of each eagerly issued
    step, apportioned across its GEMMs by roofline cost. A device time
    comes from a ``torch.profiler`` trace (``stats serve --profile``).
    """
    snap = _load_snapshot(args.file)
    device_s = snap.get("counters", {}).get("gemm.device_seconds", {})
    fractions = snap.get("histograms", {}).get("gemm.roofline_fraction", {})
    if not device_s:
        print("no utilization attribution recorded (gemm.device_seconds is "
              "empty) — run a serving workload with REPRO_METRICS=1")
        return
    rows = []
    for labels, seconds in device_s.items():
        parts = dict(p.split("=", 1) for p in labels.split(",") if "=" in p)
        h = fractions.get(labels, {})
        rows.append({
            "bucket": parts.get("bucket", "?"),
            "backend": parts.get("backend", "?"),
            "tile": parts.get("tile", "?"),
            "seconds": seconds,
            "steps": h.get("count", 0),
            "frac_mean": h.get("mean"),
            "frac_p50": h.get("p50"),
            "windowed": h.get("percentile_mode") == "windowed",
        })
    rows.sort(key=lambda r: r["seconds"], reverse=True)
    print("# wall_s: host wall time of each step apportioned by roofline cost, "
          "not device time (take that from a torch.profiler trace)")
    print(f"{'bucket':<34} {'backend':<20} {'tile':<10} "
          f"{'wall_s':>9} {'steps':>6} {'util p50':>9} {'gap':>7}")
    for r in rows[: args.n]:
        gap = None if r["frac_mean"] is None else 1.0 - r["frac_mean"]
        star = "~" if r["windowed"] else ""
        print(f"{r['bucket']:<34} {r['backend']:<20} {r['tile']:<10} "
              f"{r['seconds']:>9.4f} {r['steps']:>6} "
              f"{_fmt(r['frac_p50'], 9)}{star} {_fmt(gap, 7)}")


@contextlib.contextmanager
def _maybe_profile(trace_dir: Optional[str]):
    """Run the body under ``torch.profiler`` (the card's kernels too, when
    there is one) and export its Chrome trace to ``<trace_dir>/trace.json``."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    print(f"[stats] profile written to {path}", file=sys.stderr)


def _run_driver(args, driver_main) -> None:
    """Run a launch driver in-process under the span/profile bracket, then
    report this process's registry."""
    if not obs.enabled():
        print("[stats] warning: REPRO_METRICS=0 — the run will record "
              "nothing", file=sys.stderr)
    with _maybe_profile(args.profile):
        with obs.span(f"stats.{args.cmd}"):
            driver_main(list(args.driver_args))
    snap = obs.snapshot()
    if args.out:
        with open(args.out, "w") as f:
            _print_snapshot(snap, prom=args.prom, as_json=not args.prom,
                            out=f)
        print(f"[stats] snapshot -> {args.out}", file=sys.stderr)
    else:
        _print_snapshot(snap, prom=args.prom)


def _cmd_serve(args) -> None:
    from repro_torch.launch.serve import main as serve_main

    _run_driver(args, serve_main)


def _cmd_train(args) -> None:
    from repro_torch.launch.train import main as train_main

    _run_driver(args, train_main)


def _split_driver_args(argv: List[str]) -> (List[str], List[str]):
    """Everything after ``--`` goes to the wrapped driver verbatim."""
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:]
    return argv, []


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, driver_args = _split_driver_args(argv)

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.stats",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("snapshot", help="pretty-print / export a snapshot")
    sp.add_argument("--file", default=None,
                    help="snapshot JSON written by REPRO_METRICS_DUMP "
                         "(default: this process's live registry)")
    sp.add_argument("--prom", action="store_true",
                    help="Prometheus text exposition instead of pretty text")
    sp.add_argument("--json", action="store_true",
                    help="raw JSON instead of pretty text")
    sp.set_defaults(fn=_cmd_snapshot)

    tp = sub.add_parser("tail", help="print the last events of a JSONL log")
    tp.add_argument("--file", default=None,
                    help="event log path (default: $REPRO_EVENTS)")
    tp.add_argument("-n", type=int, default=20, help="number of events")
    tp.add_argument("--kind", default=None, help="filter by event kind")
    tp.add_argument("--follow", "-f", action="store_true",
                    help="after printing the last -n events, poll the file "
                         "and stream new ones (Ctrl-C to stop)")
    tp.add_argument("--poll", type=float, default=0.5,
                    help="follow-mode poll interval, seconds")
    tp.set_defaults(fn=_cmd_tail)

    rp = sub.add_parser(
        "trace",
        help="export the request-lifecycle trace as Chrome trace-event "
             "JSON (load in Perfetto / chrome://tracing)",
    )
    rp.add_argument("--file", default=None,
                    help="raw trace snapshot written by REPRO_TRACE_DUMP "
                         "(default: this process's live recorder)")
    rp.add_argument("--out", default=None,
                    help="write the Chrome trace JSON here (default: stdout)")
    rp.add_argument("--summary", action="store_true",
                    help="print a per-request phase table instead of JSON")
    rp.set_defaults(fn=_cmd_trace)

    op = sub.add_parser(
        "top",
        help="rank GEMM shape buckets by attributed host wall time (not "
             "device time) and utilization gap (obs.attr)",
    )
    op.add_argument("--file", default=None,
                    help="snapshot JSON (default: live registry)")
    op.add_argument("-n", type=int, default=15, help="rows to show")
    op.set_defaults(fn=_cmd_top)

    for name, fn in (("serve", _cmd_serve), ("train", _cmd_train)):
        dp = sub.add_parser(
            name,
            help=f"run the {name} driver in-process, then report its "
                 f"registry (driver args after --)",
        )
        dp.add_argument("--profile", default=None, metavar="DIR",
                        help="run under torch.profiler and write its Chrome "
                             "trace to DIR/trace.json")
        dp.add_argument("--prom", action="store_true",
                        help="report as Prometheus text")
        dp.add_argument("--out", default=None,
                        help="write the report to a file instead of stdout")
        dp.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    args.driver_args = driver_args
    args.fn(args)


if __name__ == "__main__":
    main()
