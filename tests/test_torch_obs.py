"""The port's telemetry (``repro_torch.obs``) against the JAX package's, on
the CPU.

* Metrics: the same sequence of counter, gauge and histogram operations on
  both registries gives an identical ``snapshot()`` and byte-identical
  ``prometheus_text()`` and ``to_json()``; ``percentile`` agrees on drawn
  samples; with telemetry off every fetch is the null instrument and
  ``span`` records nothing.
* Attribution: the same ``GemmRecord``s give the same ``aggregate`` and the
  same attributed histograms, under the reference's TPU v5e spec and under
  the port's H100 SXM spec (the reference given a ``HardwareSpec`` of the
  same numbers).
* The serving engine on the reduced chatglm3-6b and deepseek-moe-16b,
  monolithic and chunked with the prefix cache: ``serve.requests``,
  ``serve.tokens``, ``serve.prefix_cache.*``, ``slot_hwm`` and
  ``gemm.calls`` by (backend, family, shape), backends mapped
  ``xla`` -> ``torch``, equal the reference's; goodput is 1.0 at an SLO of
  1e9 ms, 0.0 at 1e-6 ms and None without one, on both sides.
* Audit reach: ``REPRO_AUDIT=1`` audits a direct q8 ``ops.matmul`` and no
  call inside an engine step (the reference's jitted step); a mis-scaled q8
  lane trips ``numerics_drift``.
* The scrape surface, the structured logger and ``launch.stats``.

``tests/conftest.py`` resets the reference's telemetry between tests; the
fixture below does the same for the port's.
"""

import dataclasses
import functools
import io
import json
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import roofline as j_roofline
from repro.kernels import ops as j_ops
from repro.models import api as japi
from repro.obs import attr as j_attr
from repro.quant import mlp_q8_policy as j_mlp_q8_policy
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import ServingReport as JServingReport
from repro.serve import poisson_trace as j_poisson_trace
from repro.serve import shared_prefix_trace as j_shared_prefix_trace
from repro_torch import obs as tobs
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import roofline as t_roofline
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import stats as t_stats
from repro_torch.models import api as tapi
from repro_torch.obs import attr as t_attr
from repro_torch.obs import audit as t_audit
from repro_torch.obs import http as t_http
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import tracing as t_tracing
from repro_torch.quant import mlp_q8_policy
from repro_torch.serve import ContinuousEngine, ServingReport, poisson_trace, shared_prefix_trace

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

KNOBS = ("REPRO_PREFILL_CHUNK", "REPRO_PREFIX_CACHE", "REPRO_SLO_TTFT_MS", "REPRO_SLO_ITL_MS",
         "REPRO_AUDIT", "REPRO_METRICS_PORT")


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
        t_audit.set_audit_every(None)
        t_http.shutdown()

    reset()
    yield
    reset()
    jobs.set_enabled(True)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _op_sequence(seed, n=80):
    """A drawn sequence of instrument operations, replayable on either
    package's module API."""
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(n):
        kind = ("counter", "gauge", "gauge_add", "histogram", "histogram_b")[rng.integers(0, 5)]
        name = f"x.{'abc'[rng.integers(0, 3)]}"
        labels = {}
        if rng.random() < 0.6:
            labels["backend"] = ("cuda", "torch", "xla")[rng.integers(0, 3)]
        if rng.random() < 0.3:
            labels["shape"] = int(rng.integers(0, 4))
        value = float(rng.exponential(0.05))
        seq.append((kind, name, labels, value))
    return seq


def _replay(mod, seq):
    for kind, name, labels, value in seq:
        if kind == "counter":
            mod.counter(name, **labels).inc(value)
        elif kind == "gauge":
            mod.gauge(name, **labels).set(value)
        elif kind == "gauge_add":
            mod.gauge(name, **labels).add(-value)
        elif kind == "histogram":
            mod.histogram(name, **labels).observe(value)
        else:
            mod.histogram("h." + name, buckets=(0.01, 0.1, 1.0), **labels).observe(value)


@pytest.mark.parametrize("seed", range(6))
def test_same_operations_give_identical_exports(seed):
    seq = _op_sequence(seed)
    _replay(jobs, seq)
    _replay(tobs, seq)
    assert tobs.snapshot() == jobs.snapshot()
    assert tobs.prometheus_text() == jobs.prometheus_text()
    assert tobs.to_json() == jobs.to_json()
    assert tobs.to_json(indent=None) == jobs.to_json(indent=None)


def test_windowed_reservoir_matches_the_reference():
    xs = np.random.default_rng(0).exponential(size=t_metrics._SAMPLE_CAP + 100)
    for mod in (jobs, tobs):
        h = mod.histogram("lat")
        for x in xs:
            h.observe(float(x))
    got, want = tobs.snapshot()["histograms"]["lat"][""], jobs.snapshot()["histograms"]["lat"][""]
    assert got == want
    assert got["percentile_mode"] == "windowed" and got["samples_dropped"] == 100


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(min_value=-1e12, max_value=1e12, allow_nan=False), max_size=40),
       st.floats(min_value=0.0, max_value=100.0))
def test_percentile_matches_the_reference(values, q):
    assert tobs.percentile(values, q) == jobs.percentile(values, q)


@pytest.mark.parametrize("n,q", [(0, 50), (1, 99), (2, 50), (7, 0), (7, 100), (10, 99), (33, 90)])
def test_percentile_matches_the_reference_on_fixed_draws(n, q):
    values = list(np.random.default_rng(n).normal(size=n))
    assert tobs.percentile(values, q) == jobs.percentile(values, q)


def test_serving_percentile_is_the_metrics_one():
    from repro_torch.serve import continuous

    assert continuous.percentile is t_metrics.percentile


def test_telemetry_off_fetches_null_instruments_and_span_records_nothing():
    prev = tobs.set_enabled(False)
    assert prev is True and not tobs.enabled()
    c, g, h = tobs.counter("a", x=1), tobs.gauge("b"), tobs.histogram("c")
    assert c is g is h is t_metrics._NULL
    c.inc(3)
    g.set(2.0)
    h.observe(1.0)
    with tobs.span("region"):
        pass
    tobs.event("thing", a=1)
    assert tobs.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert tobs.recent_events() == []
    assert not t_tracing.enabled()
    tobs.set_enabled(True)
    with tobs.span("region"):
        pass
    assert tobs.snapshot()["histograms"]["span.seconds"]["name=region"]["count"] == 1


def test_counters_only_go_up():
    with pytest.raises(ValueError, match="only go up"):
        tobs.counter("a").inc(-1)


# ---------------------------------------------------------------------------
# roofline and attribution
# ---------------------------------------------------------------------------


def _records(pkg_attr, seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        grouped = rng.random() < 0.3
        family = "q8" if rng.random() < 0.3 else "fp"
        m, k, n_ = (int(rng.integers(1, 600)), int(rng.choice([64, 4096, 13696])),
                    int(rng.choice([128, 4608, 27392])))
        g = int(rng.choice([4, 64])) if grouped else 0
        dt = ("bfloat16", "float32")[rng.integers(0, 2)]
        out.append(pkg_attr.GemmRecord(
            shape_family="grouped" if grouped else "dense",
            backend=("torch_q8" if family == "q8" else "torch"), family=family,
            m=m, k=k, n=n_, g=g, a_dtype=dt, b_dtype=dt, out_dtype=dt,
            tile_source="heuristic",
            tile_key=("torch", "dense", m, k, n_, g, 2)))
    return out


def _as_dicts(workload):
    return {key: dataclasses.asdict(e) for key, e in workload.items()}


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_matches_the_reference_under_tpu_v5e(seed):
    got = t_attr.aggregate(_records(t_attr, seed), hw=t_roofline.TPU_V5E)
    want = j_attr.aggregate(_records(j_attr, seed), hw=j_roofline.TPU_V5E)
    assert _as_dicts(got) == _as_dicts(want)


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_and_observe_match_the_reference_under_h100(seed):
    h100 = t_roofline.H100_SXM
    j_h100 = j_roofline.HardwareSpec(name=h100.name, peak_flops=h100.peak_flops,
                                     hbm_bw=h100.hbm_bw, ici_link_bw=h100.ici_link_bw)
    got = t_attr.aggregate(_records(t_attr, seed))  # the port's default spec
    want = j_attr.aggregate(_records(j_attr, seed), hw=j_h100)
    assert _as_dicts(got) == _as_dicts(want)
    for seconds in (1e-3, 0.05, 0.4):
        t_attr.observe_step(got, seconds)
        j_attr.observe_step(want, seconds)
    # The reference forwards tuned entries to its util-gap seam; these are
    # all heuristic, so the registries hold the same instruments.
    assert tobs.snapshot() == jobs.snapshot()
    fractions = tobs.snapshot()["histograms"]["gemm.roofline_fraction"]
    assert len({round(h["max"], 12) for h in fractions.values()}) == 1  # one per step


def test_shape_bucket_matches_the_reference():
    for a, b in zip(_records(t_attr, 5), _records(j_attr, 5)):
        assert t_attr.shape_bucket(a) == j_attr.shape_bucket(b)


@pytest.mark.parametrize("name", ["int8", "bfloat16", "float16", "float32", "float64",
                                  "float8_e4m3fn", "int32"])
def test_dtype_widths_match_the_reference_and_torch(name):
    want = j_roofline.dtype_width(name)
    assert t_roofline.dtype_width(name) == want
    assert t_roofline.dtype_width(getattr(torch, name)) == want
    assert t_roofline.dtype_width(f"torch.{name}") == want


@pytest.mark.parametrize("m,k,n,kw", [
    (4, 4096, 4608, dict(a_dtype="bfloat16")),
    (512, 4096, 13696, dict(a_dtype="int8", out_dtype="bfloat16", scale_elems=512 + 13696)),
    (7, 96, 64, dict(a_dtype="float32", b_dtype="bfloat16", c_dtype="float32")),
])
def test_gemm_bytes_and_intensity_match_the_reference(m, k, n, kw):
    assert t_roofline.gemm_bytes(m, k, n, **kw) == j_roofline.gemm_bytes(m, k, n, **kw)
    assert t_roofline.gemm_intensity(m, k, n, **kw) == j_roofline.gemm_intensity(m, k, n, **kw)
    tkw = {key: (getattr(torch, v) if key.endswith("dtype") else v) for key, v in kw.items()}
    assert t_roofline.gemm_bytes(m, k, n, **tkw) == j_roofline.gemm_bytes(m, k, n, **kw)


def test_tensor_bytes_counts_torch_tensors_at_their_widths():
    a, b = torch.zeros(3, 5, dtype=torch.bfloat16), torch.zeros(7, dtype=torch.int8)
    assert t_roofline.tensor_bytes(a, None, b) == 3 * 5 * 2 + 7


def test_spec_for_device(monkeypatch):
    assert t_roofline.spec_for_device("cpu") is t_roofline.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert t_roofline.spec_for_device("cuda") is t_roofline.H100_SXM
    for other in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=other: n)
        with pytest.raises(RuntimeError, match="no roofline spec"):
            t_roofline.spec_for_device("cuda")
    assert (t_roofline.H100_SXM.peak_flops, t_roofline.H100_SXM.hbm_bw) == (989e12, 3.35e12)


def test_direct_calls_count_every_call_and_capture_records():
    a, b = torch.randn(5, 3, 32), torch.randn(32, 16)
    with t_attr.capture_gemms() as recs:
        for _ in range(3):
            t_ops.matmul(a, b)
        t_ops.grouped_matmul(torch.randn(2, 4, 32), torch.randn(2, 32, 8), backend="q8")
    calls = tobs.snapshot()["counters"]["gemm.calls"]
    assert calls == {
        "backend=torch,family=fp,fusion=default,shape=dense,tile=heuristic": 3.0,
        "backend=torch_q8,family=q8,fusion=default,shape=grouped,tile=heuristic": 1.0,
    }
    assert [(r.shape_family, r.m, r.k, r.n, r.g, r.a_dtype) for r in recs] == (
        [("dense", 15, 32, 16, 0, "float32")] * 3 + [("grouped", 4, 32, 8, 2, "float32")])
    assert recs[-1].tile_key[-1] == 1  # q8 streams int8 panels


def test_quiet_step_scope_skips_per_call_telemetry():
    a, b = torch.randn(4, 32), torch.randn(32, 16)
    with t_attr.step_scope(True) as recs:
        t_ops.matmul(a, b)
    with t_attr.step_scope(False) as quiet:
        t_ops.matmul(a, b)
        assert t_attr.step_quiet() and t_attr.in_step()
    assert quiet is None and len(recs) == 1
    assert not t_attr.in_step()
    assert sum(tobs.snapshot()["counters"]["gemm.calls"].values()) == 1


def test_metrics_off_counts_nothing():
    tobs.set_enabled(False)
    t_ops.matmul(torch.randn(4, 32), torch.randn(32, 16), backend="q8")
    tobs.set_enabled(True)
    assert tobs.snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# the serving engine's counts and goodput
# ---------------------------------------------------------------------------

POISSON = dict(seed=3, vocab=256, prompt_lens=(5, 9, 17, 24), gen_lens=(3, 6, 11),
               mean_interarrival=1.5)
SHARED = dict(seed=2, vocab=256, prefix_len=24, tail_lens=(3, 6), gen_lens=(3, 5),
              mean_interarrival=1.0)
MODES = {
    "monolithic": (j_poisson_trace, poisson_trace, 7, POISSON,
                   dict(n_slots=2, max_len=40)),
    "chunked_prefix": (j_shared_prefix_trace, shared_prefix_trace, 5, SHARED,
                       dict(n_slots=2, max_len=48, prefill_chunk=8, prefix_cache=True,
                            prefix_block=8)),
}


def _serve_both(arch, mode, repeats=1, **extra):
    j_trace, t_trace, n, kw, fields = MODES[mode]
    jcfg, tcfg, jparams, tparams = _model(arch)
    jeng = JContinuous(cfg=jcfg, params=jparams, cache_dtype=jnp.float32, **fields, **extra)
    teng = ContinuousEngine(cfg=tcfg, params=tparams, cache_dtype=torch.float32, **fields,
                            **extra)
    for _ in range(repeats):
        want = jeng.serve(j_trace(n, **kw))
        got = teng.serve(t_trace(n, **kw))
    return want, got


def _labels(s):
    return dict(p.split("=", 1) for p in s.split(",") if p)


def _gemm_calls(snap):
    """gemm.calls by (backend, family, shape), backends mapped to the port's."""
    names = {"xla": "torch", "xla_q8": "torch_q8"}
    out = {}
    for label, v in snap["counters"].get("gemm.calls", {}).items():
        d = _labels(label)
        key = (names.get(d["backend"], d["backend"]), d["family"], d["shape"])
        out[key] = out.get(key, 0) + v
    return out


def _serving_counts(snap):
    c, g = snap["counters"], snap["gauges"]
    return {
        "requests": c.get("serve.requests"),
        "tokens": c.get("serve.tokens"),
        **{f"prefix.{k}": c.get(f"serve.prefix_cache.{k}") for k in ("hits", "misses",
                                                                       "evictions")},
        **{f"gauge.{k}": g.get(k) for k in ("serve.prefix_cache.cached_tokens",
                                            "serve.prefix_cache.hwm_tokens",
                                            "serve.slot_pool_hwm", "serve.queue_depth")},
    }


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b"])
def test_engine_counts_match_the_reference(arch, mode):
    want, got = _serve_both(arch, mode)
    assert got.outputs == want.outputs
    assert got.slot_hwm == want.slot_hwm > 0
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    assert _serving_counts(tsnap) == _serving_counts(jsnap)
    n = len(got.outputs)
    assert tsnap["counters"]["serve.requests"] == {"event=admitted": n, "event=retired": n}
    assert tsnap["counters"]["serve.tokens"][""] == got.generated_tokens - n
    calls = _gemm_calls(tsnap)
    assert calls == _gemm_calls(jsnap)
    if arch == "deepseek-moe-16b":
        assert calls[("torch", "fp", "grouped")] > 0
    if mode == "chunked_prefix":
        assert tsnap["counters"]["serve.prefix_cache.hits"][""] > 0


def test_engine_counts_do_not_grow_with_repeated_serves():
    """A step key is captured once per engine, as the reference traces once."""
    want, got = _serve_both("chatglm3-6b", "chunked_prefix", repeats=2)
    assert got.outputs == want.outputs
    assert _gemm_calls(tobs.snapshot()) == _gemm_calls(jobs.snapshot())
    assert _serving_counts(tobs.snapshot()) == _serving_counts(jobs.snapshot())


def test_every_step_bucket_gets_a_roofline_fraction():
    _, got = _serve_both("chatglm3-6b", "monolithic")
    snap = tobs.snapshot()
    buckets = {_labels(k)["bucket"] for k in snap["histograms"]["gemm.roofline_fraction"]}
    # The decode step (2 slots) and each prefill's row count.
    assert any(b.startswith("dense:2x") for b in buckets)
    for h in snap["histograms"]["gemm.roofline_fraction"].values():
        assert 0.0 < h["max"] <= 1.0
    assert sum(snap["counters"]["gemm.device_seconds"].values()) > 0


@pytest.mark.parametrize("slo,want", [(dict(slo_ttft_ms=1e9), 1.0), (dict(slo_ttft_ms=1e-6), 0.0),
                                      (dict(slo_itl_ms=1e9), 1.0),
                                      (dict(slo_ttft_ms=1e9, slo_itl_ms=1e-6), 0.0),
                                      ({}, None)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_goodput_matches_the_reference(mode, slo, want):
    jrep, trep = _serve_both("chatglm3-6b", mode, **slo)
    assert trep.goodput == jrep.goodput == want
    nones = {f.name for f in dataclasses.fields(trep) if getattr(trep, f.name) is None}
    assert nones == {f.name for f in dataclasses.fields(jrep) if getattr(jrep, f.name) is None}
    if mode == "monolithic":
        assert {"attach_p50", "chunk_prefill_p50"} <= nones
    assert trep.queue_p50 is not None and trep.slot_hwm == jrep.slot_hwm


def test_serving_report_has_every_field_of_the_reference():
    assert ([f.name for f in dataclasses.fields(ServingReport)]
            == [f.name for f in dataclasses.fields(JServingReport)])


def test_slo_knobs_resolve_as_the_reference(monkeypatch):
    jcfg, tcfg, jparams, tparams = _model("chatglm3-6b")
    monkeypatch.setenv("REPRO_SLO_TTFT_MS", "250")
    monkeypatch.setenv("REPRO_SLO_ITL_MS", "40.5")
    want = JContinuous(cfg=jcfg, params=jparams, n_slots=2, max_len=32)
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32)
    assert (got.slo_ttft_ms, got.slo_itl_ms) == (want.slo_ttft_ms, want.slo_itl_ms) == (250.0, 40.5)
    got = ContinuousEngine(cfg=tcfg, params=tparams, n_slots=2, max_len=32, slo_ttft_ms=7.0)
    assert got.slo_ttft_ms == 7.0  # fields beat the environment


def test_engine_events_match_the_reference():
    _serve_both("chatglm3-6b", "monolithic")
    strip = lambda e: {k: v for k, v in e.items() if k not in ("ts", "uid")}  # noqa: E731
    got = [strip(e) for e in tobs.recent_events(kind="request_retired")]
    want = [strip(e) for e in jobs.recent_events(kind="request_retired")]
    assert got == want and len(got) == 7
    report = tobs.recent_events(kind="serving_report")
    assert len(report) == 1 and report[0]["requests"] == 7


# ---------------------------------------------------------------------------
# audit
# ---------------------------------------------------------------------------


def _q8_operands(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(6, 64)).astype(np.float32),
            rng.normal(size=(64, 48)).astype(np.float32))


def test_audit_one_direct_q8_matmul_like_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_AUDIT", "1")
    a, b = _q8_operands()
    t_ops.matmul(torch.from_numpy(a), torch.from_numpy(b), backend="q8")
    j_ops.matmul(jnp.asarray(a), jnp.asarray(b), backend="xla_q8")
    tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
    assert tsnap["counters"]["numerics.audits"] == {"backend=torch_q8,family=q8,shape=dense": 1.0}
    assert jsnap["counters"]["numerics.audits"] == {"backend=xla_q8,family=q8,shape=dense": 1.0}
    got = tsnap["histograms"]["numerics.rel_err"]["backend=torch_q8,family=q8,shape=dense"]
    want = jsnap["histograms"]["numerics.rel_err"]["backend=xla_q8,family=q8,shape=dense"]
    assert got["max"] < 0.05
    np.testing.assert_allclose(got["max"], want["max"], rtol=1e-4)
    assert "numerics.drift" not in tsnap["counters"]
    assert tobs.recent_events(kind="numerics_drift") == []


def test_audit_samples_one_in_n_and_skips_fp_calls():
    t_audit.set_audit_every(3)
    a, b = (torch.from_numpy(x) for x in _q8_operands())
    for _ in range(7):
        t_ops.matmul(a, b, backend="q8")
    t_ops.matmul(a, b)  # the fp family is never audited
    t_ops.grouped_matmul(a[None], b[None], backend="q8")  # the 8th eligible call: no
    t_ops.grouped_matmul(a[None], b[None], backend="q8")  # the 9th: audited
    audits = tobs.snapshot()["counters"]["numerics.audits"]
    assert audits == {"backend=torch_q8,family=q8,shape=dense": 2.0,
                      "backend=torch_q8,family=q8,shape=grouped": 1.0}


def test_no_call_inside_an_engine_step_is_audited_like_a_jitted_step(monkeypatch):
    monkeypatch.setenv("REPRO_AUDIT", "1")
    jcfg, tcfg, jparams, tparams = _model("chatglm3-6b")
    tok = np.array([[3], [7]])
    tcaches = tapi.init_state(tcfg, 2, 16, torch.float32, "cpu")
    jcaches = japi.init_state(jcfg, 2, 16, jnp.float32)
    pos = np.array([0, 0])
    for capture in (True, False):
        with t_attr.step_scope(capture):
            tapi.decode_at(tcfg, tparams, torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                           backend=mlp_q8_policy())
    jax.jit(lambda p, t, c, q: japi.decode_at(jcfg, p, t, c, q, backend=j_mlp_q8_policy()))(
        jparams, jnp.asarray(tok, jnp.int32), jcaches, jnp.asarray(pos, jnp.int32))
    assert "numerics.audits" not in tobs.snapshot()["counters"]
    assert "numerics.audits" not in jobs.snapshot()["counters"]
    # The same step outside a scope audits its q8 calls (the MLP's three).
    tapi.decode_at(tcfg, tparams, torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                   backend=mlp_q8_policy())
    assert sum(tobs.snapshot()["counters"]["numerics.audits"].values()) == 3


def test_a_mis_scaled_q8_lane_trips_numerics_drift(monkeypatch):
    monkeypatch.setenv("REPRO_AUDIT", "1")
    be = t_ops.backend("torch_q8")
    orig = be.fn
    monkeypatch.setattr(be, "fn", lambda *a, **k: orig(*a, **k) * 1.5)
    a, b = (torch.from_numpy(x) for x in _q8_operands(1))
    t_ops.matmul(a, b, backend="q8")
    drift = tobs.recent_events(kind="numerics_drift")
    assert len(drift) == 1
    assert drift[0]["rel_err"] > 0.05 and drift[0]["threshold"] == 0.05
    assert (drift[0]["m"], drift[0]["k"], drift[0]["n"]) == (6, 64, 48)
    assert tobs.snapshot()["counters"]["numerics.drift"] == {
        "backend=torch_q8,family=q8,shape=dense": 1.0}


def test_the_q8_policy_is_the_reference_one():
    assert t_audit.get_policy("q8") == t_audit.AuditPolicy(rel_err=0.05)
    from repro.obs import audit as j_audit

    assert j_audit.get_policy("q8").rel_err == t_audit.get_policy("q8").rel_err


# ---------------------------------------------------------------------------
# scrape surface, logger, stats CLI
# ---------------------------------------------------------------------------


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
        return r.read().decode()


def test_metrics_scrape_equals_prometheus_text(monkeypatch):
    assert t_http.maybe_serve_from_env() is None
    monkeypatch.setenv("REPRO_METRICS_PORT", "0")
    server = t_http.maybe_serve_from_env()
    assert server is not None and server.host == "127.0.0.1" and server.port > 0
    _serve_both("chatglm3-6b", "chunked_prefix")
    assert _get(server, "/metrics") == tobs.prometheus_text()
    assert json.loads(_get(server, "/requests")) == []  # nothing in flight
    doc = json.loads(_get(server, "/trace"))
    assert t_tracing.validate_chrome_trace(doc) == 5
    assert "/metrics" in _get(server, "/")
    with pytest.raises(urllib.error.HTTPError):
        _get(server, "/nope")
    assert t_http.serve_metrics() is server  # one server a process
    t_http.shutdown()
    assert t_http.current_server() is None


@pytest.mark.parametrize("mode", ["text", "json"])
def test_logger_matches_the_reference(monkeypatch, mode):
    from repro.obs.logging import Logger as JLogger

    monkeypatch.setenv("REPRO_LOG", mode)
    outs = []
    for cls in (tobs.Logger, JLogger):
        buf = io.StringIO()
        lg = cls("serve", stream=buf)
        lg.info("served", tokens=128, wall_s=1.23456789, name="a b", empty="")
        lg.raw("plain line")
        outs.append(buf.getvalue())
    if mode == "json":
        outs = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
                 for line in o.splitlines()] for o in outs]
    assert outs[0] == outs[1]


def test_event_log_sink_and_tail(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    assert t_stats.main(["tail", "--file", str(path)]) is None
    assert "no events recorded" in capsys.readouterr().out
    prev = tobs.set_event_log(str(path))
    try:
        for i in range(5):
            tobs.event("tick", i=i)
        tobs.event("other")
    finally:
        tobs.set_event_log(prev)
    assert [e["i"] for e in tobs.read_events(str(path), n=6) if e["kind"] == "tick"] == list(range(5))
    t_stats.main(["tail", "--file", str(path), "-n", "2", "--kind", "tick"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["i"] for x in lines] == [3, 4]
    stop = iter([False, True])
    follow = list(tobs.follow_events(str(path), poll_interval=0.01, stop=lambda: next(stop)))
    assert len(follow) == 6


def test_stats_snapshot_and_top_read_a_dump(tmp_path, capsys):
    from repro.launch import stats as j_stats

    _serve_both("chatglm3-6b", "monolithic")
    path = tmp_path / "snap.json"
    path.write_text(tobs.to_json())
    t_stats.main(["snapshot", "--file", str(path), "--prom"])
    prom = capsys.readouterr().out
    assert prom == tobs.prometheus_text()
    j_stats.main(["snapshot", "--file", str(path), "--prom"])
    assert capsys.readouterr().out == prom  # the same exporter on both sides
    t_stats.main(["snapshot", "--file", str(path)])
    text = capsys.readouterr().out
    assert "serve.ttft_seconds" in text and "gemm.calls" in text
    t_stats.main(["top", "--file", str(path), "-n", "3"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0].startswith("# wall_s: host wall time") and "not device time" in rows[0]
    assert rows[1].split()[:2] == ["bucket", "backend"] and len(rows) == 5
    assert all(re.match(r"dense:\d+x\d+x\d+", r) for r in rows[2:])


def test_stats_serve_runs_the_driver_in_process(tmp_path, capsys):
    out = tmp_path / "snap.json"
    t_stats.main(["serve", "--out", str(out), "--", "--arch", "chatglm3-6b", "--reduced",
                  "--device", "cpu", "--n-requests", "3", "--gen", "4", "--prompt-len", "8"])
    snap = json.loads(out.read_text())
    assert snap["counters"]["serve.requests"] == {"event=admitted": 3.0, "event=retired": 3.0}
    assert snap["histograms"]["span.seconds"]["name=stats.serve"]["count"] == 1
    assert '"engine": "continuous"' in capsys.readouterr().out


def test_stats_train_is_not_ported_yet(monkeypatch):
    # The training loop is ported now: `stats train` runs the port's train
    # launcher, which defaults to the card and, without one, raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_stats.main(["train", "--", "--arch", "chatglm3-6b"])


def test_launch_serve_reports_phases_and_goodput(monkeypatch, capsys):
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setenv("REPRO_SLO_TTFT_MS", "1e9")
    monkeypatch.setenv("REPRO_METRICS_PORT", "0")
    out = launch_serve.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
                             "--n-requests", "3", "--gen", "4", "--prompt-len", "8"])
    assert out["goodput"] == 1.0 and out["slot_hwm"] >= 1 and out["queue_p50_s"] is not None
    text = capsys.readouterr().out
    assert "[serve] metrics_server port=" in text and "[serve] goodput fraction=1" in text
    assert t_http.current_server() is not None
