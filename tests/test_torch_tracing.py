"""The port's request-lifecycle tracing against the JAX package's, on the CPU.

* Recorder: the same recorder calls give the same snapshot, the same
  ``active_requests`` and an identical ``chrome_trace()`` document; each
  package's ``validate_chrome_trace`` accepts the other's document and
  rejects the same malformed ones.
* Engine, monolithic and chunked with the prefix cache, on the reduced
  chatglm3-6b and deepseek-moe-16b: per request the phase names come in the
  reference's order, ``queue + prefix_attach + chunk_prefill`` (or
  ``queue + prefill``) equals the request's TTFT to 1e-9 s, and the same
  instants are recorded.
* ``launch.stats trace`` converts a raw dump (``REPRO_TRACE_DUMP``) as the
  reference's CLI does.
* Zero device cost: the ``torch.profiler`` op-name sequence of a
  ``decode_at`` step and of a whole serve is identical with telemetry on and
  off, and the greedy outputs are identical.
"""

import functools
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.obs import tracing as j_tracing
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import poisson_trace as j_poisson_trace
from repro.serve import shared_prefix_trace as j_shared_prefix_trace
from repro_torch import obs as tobs
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import stats as t_stats
from repro_torch.models import api as tapi
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import tracing as t_tracing
from repro_torch.serve import ContinuousEngine, poisson_trace, shared_prefix_trace

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS", "REPRO_SLO_ITL_MS",
         "REPRO_TRACE", "REPRO_AUDIT")


@pytest.fixture(autouse=True)
def _reset_port_telemetry(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)

    def reset():
        tobs.reset()
        tobs.clear_events()
        t_tracing.reset()
        t_tracing.set_enabled(None)
        t_metrics.set_enabled(True)

    reset()
    yield
    reset()


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def _script(seed, n_req=6):
    """A drawn sequence of recorder calls with explicit timestamps."""
    rng = np.random.default_rng(seed)
    t = 100.0
    calls = []
    live = []
    for uid in range(n_req):
        t += float(rng.exponential(0.01))
        calls.append(("begin_request", uid, f"r{uid}" if rng.random() < 0.5 else uid, t))
        live.append(uid)
        if rng.random() < 0.7:
            calls.append(("set_slot", uid, int(rng.integers(0, 4))))
        calls.append(("annotate", uid, {"bucket": int(rng.integers(8, 64)),
                                        "fallthrough": bool(rng.random() < 0.3)}))
        for name in ("prefix_attach", "chunk_prefill", "decode")[: int(rng.integers(1, 4))]:
            t += float(rng.exponential(0.01))
            calls.append(("begin_phase", uid, name, t))
            calls.append(("instant", uid, "token", t, {"itl_s": float(rng.random())}))
            if name == "chunk_prefill":
                calls.append(("slice_event", uid, "chunk", t, t + 0.001, {"offset": 0, "end": 8}))
        if rng.random() < 0.7:
            t += float(rng.exponential(0.01))
            calls.append(("end_request", uid, ("eos", "budget")[rng.integers(0, 2)], t))
            live.remove(uid)
    calls.append(("instant", 12345, "token", t, {}))  # unknown uid: dropped
    return calls, t


def _play(rec, calls):
    for c in calls:
        name, args = c[0], list(c[1:])
        kw = args.pop() if args and isinstance(args[-1], dict) else {}
        getattr(rec, name)(*args, **kw)


def _pair(seed):
    calls, t_end = _script(seed)
    recs = (t_tracing.TraceRecorder(cap=4), j_tracing.TraceRecorder(cap=4))
    for rec in recs:
        rec._epoch, rec._perf0 = 1.7e9, 99.5  # one clock anchor for both
        _play(rec, calls)
    return recs, t_end


@pytest.mark.parametrize("seed", range(5))
def test_same_recorder_calls_give_an_identical_trace(seed):
    (got, want), t_end = _pair(seed)
    assert got.snapshot() == want.snapshot()
    assert got.active_requests(now=t_end + 1.0) == want.active_requests(now=t_end + 1.0)
    doc = t_tracing.chrome_trace(got.snapshot())
    assert doc == j_tracing.chrome_trace(want.snapshot())
    assert json.dumps(doc) == json.dumps(j_tracing.chrome_trace(want.snapshot()))
    assert t_tracing.validate_chrome_trace(doc) == j_tracing.validate_chrome_trace(doc)
    jdoc = j_tracing.chrome_trace(want.snapshot())
    assert t_tracing.validate_chrome_trace(jdoc) == j_tracing.validate_chrome_trace(jdoc)


BAD_DOCS = [
    {},
    {"traceEvents": []},
    {"traceEvents": [{"ph": "e", "cat": "request", "id": 1, "ts": 0.0}]},
    {"traceEvents": [{"ph": "b", "cat": "request", "id": 1, "ts": 0.0},
                     {"ph": "b", "cat": "request", "id": 1, "ts": 1.0}]},
    {"traceEvents": [{"ph": "b", "cat": "request", "id": 1, "ts": 5.0},
                     {"ph": "e", "cat": "request", "id": 1, "ts": 1.0}]},
    {"traceEvents": [{"ph": "X", "name": "q", "dur": -1.0, "ts": 0.0}]},
    {"traceEvents": [{"ph": "b", "cat": "request", "id": 1, "ts": 0.0},
                     {"ph": "e", "cat": "request", "id": 1, "ts": 1.0}]},
]


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_validators_reject_the_same_documents(i):
    with pytest.raises(ValueError) as got:
        t_tracing.validate_chrome_trace(BAD_DOCS[i])
    with pytest.raises(ValueError) as want:
        j_tracing.validate_chrome_trace(BAD_DOCS[i])
    assert str(got.value) == str(want.value)


def test_trace_off_by_env_and_by_override(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "0")
    assert not t_tracing.enabled()
    t_tracing.begin_request(1, 1, 0.0)
    assert t_tracing.snapshot()["requests"] == []
    t_tracing.set_enabled(True)
    t_tracing.begin_request(1, 1, 0.0)
    assert len(t_tracing.snapshot()["requests"]) == 1
    t_metrics.set_enabled(False)  # the registry's hard-off wins
    assert not t_tracing.enabled()


def test_instants_are_capped_and_counted(monkeypatch):
    monkeypatch.setattr(t_tracing, "_MAX_INSTANTS", 3)
    t_tracing.begin_request(7, 7, 0.0)
    for i in range(5):
        t_tracing.instant(7, "token", float(i))
    (req,) = t_tracing.snapshot()["requests"]
    assert len(req["instants"]) == 3 and req["meta"]["instants_dropped"] == 2


def test_the_retired_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_CAP", "2")
    rec = t_tracing.TraceRecorder()
    for uid in range(4):
        rec.begin_request(uid, uid, float(uid))
        rec.end_request(uid, "budget", uid + 0.5)
    assert [r["uid"] for r in rec.snapshot()["requests"]] == [2, 3]


# ---------------------------------------------------------------------------
# the engine's lifecycle
# ---------------------------------------------------------------------------

POISSON = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17, 24), gen_lens=(3, 6, 11),
               mean_interarrival=1.5)
SHARED = dict(seed=2, vocab=256, prefix_len=24, tail_lens=(3, 6), gen_lens=(3, 5),
              mean_interarrival=1.0)
MODES = {
    "monolithic": (j_poisson_trace, poisson_trace, 7, POISSON, dict(n_slots=2, max_len=40)),
    "chunked_prefix": (j_shared_prefix_trace, shared_prefix_trace, 5, SHARED,
                       dict(n_slots=2, max_len=48, prefill_chunk=8, prefix_cache=True,
                            prefix_block=8)),
}


def _by_rid(snap):
    return {r["rid"]: r for r in snap["requests"]}


def _dur(req, name):
    return sum(p["t1"] - p["t0"] for p in req["phases"] if p["name"] == name)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_engine_phases_match_the_reference_and_sum_to_ttft(arch, mode):
    j_trace, t_trace, n, kw, fields = MODES[mode]
    jcfg, tcfg, jparams, tparams = _model(arch)
    want_rep = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32,
                           **fields).serve(j_trace(n, **kw))
    got_rep = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32,
                               **fields).serve(t_trace(n, **kw))
    assert got_rep.outputs == want_rep.outputs
    got, want = _by_rid(t_tracing.snapshot()), _by_rid(j_tracing.snapshot())
    assert sorted(got) == sorted(want) == list(range(n))
    pre = ("queue", "prefix_attach", "chunk_prefill") if mode != "monolithic" else (
        "queue", "prefill")
    ttfts = []
    for rid in got:
        g, w = got[rid], want[rid]
        assert [p["name"] for p in g["phases"]] == [p["name"] for p in w["phases"]]
        assert [p["name"] for p in g["phases"]] == list(pre) + ["decode"]
        assert Counter(i["name"] for i in g["instants"]) == Counter(
            i["name"] for i in w["instants"])
        assert g["retire_reason"] == w["retire_reason"] == "budget"
        assert (g["slot"] is None) == (w["slot"] is None)
        assert sorted(g["meta"]) == sorted(w["meta"])
        assert [s["name"] for s in g["slices"]] == [s["name"] for s in w["slices"]]
        (first,) = [i for i in g["instants"] if i["name"] == "first_token"]
        assert abs(sum(_dur(g, p) for p in pre) - first["ttft_s"]) <= 1e-9
        ttfts.append(first["ttft_s"])
        # Contiguous phases: each opens where the last closed.
        for a, b in zip(g["phases"], g["phases"][1:]):
            assert a["t1"] == b["t0"]
    # The same TTFT samples feed the histogram and the report.
    h = tobs.snapshot()["histograms"]["serve.ttft_seconds"][""]
    assert h["count"] == n and abs(h["sum"] - sum(ttfts)) <= 1e-9
    assert got_rep.ttft_p50 == tobs.percentile(ttfts, 50)
    doc = t_tracing.chrome_trace()
    assert t_tracing.validate_chrome_trace(doc) == j_tracing.validate_chrome_trace(doc) == n


def test_stats_trace_converts_a_raw_dump_like_the_reference(tmp_path, capsys):
    from repro.launch import stats as j_stats

    j_trace, t_trace, n, kw, fields = MODES["chunked_prefix"]
    _, tcfg, _, tparams = _model("chatglm3-6b")
    ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32,
                     **fields).serve(t_trace(n, **kw))
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(t_tracing.snapshot()))
    out, jout = tmp_path / "timeline.json", tmp_path / "j_timeline.json"
    t_stats.main(["trace", "--file", str(raw), "--out", str(out)])
    j_stats.main(["trace", "--file", str(raw), "--out", str(jout)])
    doc = json.loads(out.read_text())
    assert doc == json.loads(jout.read_text())
    assert t_tracing.validate_chrome_trace(doc) == j_tracing.validate_chrome_trace(doc) == n
    capsys.readouterr()
    t_stats.main(["trace", "--file", str(raw), "--summary"])
    summary = capsys.readouterr().out
    j_stats.main(["trace", "--file", str(raw), "--summary"])
    assert capsys.readouterr().out == summary
    assert len(summary.splitlines()) == n + 1 and "attach_ms" in summary


def test_dump_hooks_write_at_exit(tmp_path):
    trace_path, snap_path = tmp_path / "raw.json", tmp_path / "snap.json"
    code = (
        "import torch\n"
        "from repro_torch import obs\n"
        "from repro_torch.obs import tracing\n"
        "from repro_torch.kernels import ops\n"
        "ops.matmul(torch.ones(2, 8), torch.ones(8, 4))\n"
        "tracing.begin_request(1, 'a', 1.0)\n"
        "tracing.end_request(1, 'budget', 2.0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TRACE_DUMP=str(trace_path),
               REPRO_METRICS_DUMP=str(snap_path))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    snap = json.loads(snap_path.read_text())
    assert list(snap["counters"]["gemm.calls"].values()) == [1.0]
    raw = json.loads(trace_path.read_text())
    assert t_tracing.validate_chrome_trace(t_tracing.chrome_trace(raw)) == 1
    # With nothing recorded, both hooks leave their paths alone: a dump the
    # other package wrote there survives.
    snap_path.write_text("other")
    trace_path.write_text("other")
    subprocess.run([sys.executable, "-c", "import repro_torch.obs"], env=env, check=True,
                   timeout=120)
    assert snap_path.read_text() == trace_path.read_text() == "other"


# ---------------------------------------------------------------------------
# zero device cost
# ---------------------------------------------------------------------------


def _op_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(prof.events(), key=lambda e: (e.time_range.start, -e.time_range.end))
    return [e.name for e in events], out


def _with_telemetry(flag, fn):
    prev = t_metrics.set_enabled(flag)
    try:
        return _op_names(fn)
    finally:
        t_metrics.set_enabled(prev)


def test_decode_step_ops_are_the_same_with_telemetry_on_and_off():
    _, tcfg, _, tparams = _model("chatglm3-6b")
    tok = torch.tensor([[3], [7], [1], [9]])
    pos = torch.tensor([0, 1, 2, 3])

    def step():
        caches = tapi.init_state(tcfg, 4, 16, torch.float32, "cpu")
        with torch.inference_mode():
            return tapi.decode_at(tcfg, tparams, tok, caches, pos)[0]

    on, logits_on = _with_telemetry(True, step)
    off, logits_off = _with_telemetry(False, step)
    assert on == off and len(on) > 50
    assert torch.equal(logits_on, logits_off)
    assert any("mm" in name for name in on)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_whole_serve_ops_are_the_same_with_telemetry_on_and_off(mode):
    _, t_trace, n, kw, fields = MODES[mode]
    _, tcfg, _, tparams = _model("chatglm3-6b")

    def serve():
        eng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32,
                               slo_ttft_ms=1e9, **fields)
        return eng.serve(t_trace(n, **kw))

    on, rep_on = _with_telemetry(True, serve)
    assert tobs.snapshot()["counters"]["serve.tokens"]  # telemetry did record
    assert t_tracing.snapshot()["requests"]
    off, rep_off = _with_telemetry(False, serve)
    assert on == off and len(on) > 500
    assert rep_on.outputs == rep_off.outputs
    assert rep_on.goodput == 1.0 and rep_off.goodput == 1.0  # the report is product
