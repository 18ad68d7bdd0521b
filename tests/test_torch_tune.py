"""The port's tuning subsystem (``repro_torch.tune``, the plan path of
``repro_torch.kernels.ops``) against the JAX package's, on the CPU.

* Tables: files written by ``repro.tune.table`` load in the port entry for
  entry and the reverse (an entry's ``splits``, the port's addition, is
  skipped by the reference's reader); the same split-free entries save to
  byte-identical files in both packages.
* The cycle model and the tile ranking (``simulate_gemm``, ``choose_tile``,
  ``rank_plans``) equal the reference's on a grid of shapes.
* ``harvest_model_shapes`` on the meta device gives the reference's
  ``jax.eval_shape`` harvest for chatglm3-6b and deepseek-moe-16b at their
  published widths, and under ``mlp_q8_policy()``.
* The retune seams (``on_miss_streak``, ``on_util_gap``,
  ``retune_candidate``) give the reference's counters and events for the
  same sequence of lookups and observations; ``observe_step`` feeds them.
* With no table every resolved plan is the kernel module's ``_plan``, for
  every main-path shape of both models and their q8 policies, and the
  ``cuda``/``cuda_q8`` members of a model forward hand the kernels no plan
  (each runs its own ``_plan``) and skip the resolver.
* Shape capture: ``meta`` calls compute nothing, real ones compute, and a
  capture records only its own thread's calls.
* Resolution from a table: a tuned entry serves (``tile_source``, the
  ``gemm.calls`` label, the ``GemmRecord``), illegal entries warn and the
  heuristic serves, another device kind's entry is inert, a corrupt file
  warns once; a tuned ``fuse_epilogue=False`` takes the post-hoc lane.
* ``tune_shape`` with the timer stubbed (every legal plan timed, the
  heuristic among them, the minimum wins, the fusion verdict recorded, the
  refusals), the plan API of K1, K2, K4 and K5, and the CLI's flags (the
  reference's but ``--top-k``) and its refusal without a card.

``tests/conftest.py`` resets the reference's telemetry and tile state; the
fixture below does the same for the port's, and drops the port's loaded
table before and after every test.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import re
import threading
import warnings

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import engine as j_engine
from repro.core import tiling as j_tiling
from repro.kernels import ops as j_ops
from repro.launch import tune as j_launch_tune
from repro.quant import mlp_q8_policy as j_mlp_q8_policy
from repro.tune import capture as j_capture
from repro.tune import table as j_table
from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.core import engine as t_engine
from repro_torch.core import tiling as t_tiling
from repro_torch.kernels import ops
from repro_torch.launch import tune as t_launch_tune
from repro_torch.models import api
from repro_torch.obs import attr as t_attr
from repro_torch.quant import PrecisionPolicy, mlp_q8_policy
from repro_torch.quant import opope_q8 as q8k
from repro_torch.tune import capture as t_capture
from repro_torch.tune import retune as t_retune
from repro_torch.tune import search
from repro_torch.tune import table as t_table

k1 = importlib.import_module("repro_torch.kernels.opope_gemm")
k4 = importlib.import_module("repro_torch.kernels.opope_grouped")
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _port_tune_state(monkeypatch):
    monkeypatch.delenv(t_table.ENV_VAR, raising=False)
    tobs.reset()
    tobs.clear_events()
    ops.clear_tile_cache()
    ops.reset_tile_cache_stats()
    yield
    ops.clear_tile_cache()
    ops.reset_tile_cache_stats()
    ops.on_miss_streak(None)
    ops.on_util_gap(None)
    tobs.reset()
    tobs.clear_events()


def _active(monkeypatch, tmp_path, entries, name="t.json"):
    """Save ``entries`` as the port's active table and drop the memos."""
    path = tmp_path / name
    t_table.TuningTable(entries).save(str(path))
    monkeypatch.setenv(t_table.ENV_VAR, str(path))
    ops.clear_tile_cache()
    return path


def _entry(backend, family, m, k, n, g=0, block=(128, 128, 64), splits=1, dtype="bfloat16",
           device="cpu", fuse=None, us=1.5):
    return t_table.TuneEntry(
        key=t_table.TuneKey(backend=backend, shape_family=family, m=m, k=k, n=n, g=g,
                            dtype=dtype, device_kind=device),
        block=block, us=us, gflops=2.0 * m * k * n * max(g, 1) / us / 1e3, modeled_cycles=1234,
        fuse_epilogue=fuse, splits=splits)


# --- tables ---------------------------------------------------------------------------

J_ENTRIES = [
    j_table.TuneEntry(j_table.TuneKey("pallas", "dense", 512, 512, 512, 0, "float32", "cpu"),
                      (128, 256, 256), 10.5, 25.6, 4096),
    j_table.TuneEntry(j_table.TuneKey("pallas_q8", "grouped", 64, 256, 128, 8, "int8",
                                      "tpu-v5-lite-podslice"),
                      (32, 128, 128), 3.25, 1.5, None, "measured", False),
    j_table.TuneEntry(j_table.TuneKey("pallas", "dense", 8, 128, 128, 0, "bfloat16", "cpu"),
                      (8, 128, 128), 0.75, 0.5, 99, "measured", True),
]


def _same_entry(t, j):
    assert (t.key.to_json(), t.block, t.us, t.gflops, t.modeled_cycles, t.source,
            t.fuse_epilogue) == (j.key.to_json(), j.block, j.us, j.gflops, j.modeled_cycles,
                                 j.source, j.fuse_epilogue)


def test_reference_table_loads_in_port_entry_for_entry(tmp_path):
    path = tmp_path / "ref.json"
    j_table.TuningTable(J_ENTRIES).save(str(path))
    got = t_table.TuningTable.load(str(path))
    assert len(got) == len(J_ENTRIES)
    for t, j in zip(got.entries, J_ENTRIES):
        _same_entry(t, j)
        assert t.splits == 1
    assert got.lookup(backend="pallas", shape_family="dense", m=512, k=512, n=512,
                      itemsize=4, device="cpu") == (128, 256, 256)
    assert got.lookup_fusion(backend="pallas", shape_family="dense", m=8, k=128, n=128,
                             itemsize=2, device="cpu") is True


def test_port_table_loads_in_reference_splits_skipped(tmp_path):
    entries = [_entry("cuda", "dense", 4, 4096, 4096, splits=8, block=(64, 128, 64)),
               _entry("cuda_q8", "grouped", 30, 2048, 1408, g=64, block=(8, 128, 128),
                      dtype="int8", fuse=False),
               _entry("cuda", "dense", 512, 4096, 13696, device="nvidia-h100-80gb-hbm3")]
    path = tmp_path / "port.json"
    t_table.TuningTable(entries).save(str(path))
    assert json.loads(path.read_text())["entries"][0]["splits"] == 8
    assert "splits" not in json.loads(path.read_text())["entries"][1]
    got = j_table.TuningTable.load(str(path))
    for j, t in zip(got.entries, entries):
        _same_entry(t, j)
    back = t_table.TuningTable.load(str(path))
    assert [e.splits for e in back.entries] == [8, 1, 1]
    assert back.lookup_entry(backend="cuda", shape_family="dense", m=4, k=4096, n=4096,
                             itemsize=2, device="cpu") == entries[0]


def test_split_free_entries_save_byte_identical(tmp_path):
    port = [t_table.TuneEntry(
        t_table.TuneKey(**e.key.to_json()), e.block, e.us, e.gflops, e.modeled_cycles,
        e.source, e.fuse_epilogue) for e in J_ENTRIES]
    j_table.TuningTable(J_ENTRIES).save(str(tmp_path / "j.json"))
    t_table.TuningTable(port).save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    assert t_table.SCHEMA_VERSION == j_table.SCHEMA_VERSION == 1
    assert t_table.ENV_VAR == j_table.ENV_VAR == "REPRO_TUNE_TABLE"
    assert t_table.DEFAULT_TABLE_PATH.endswith("repro_torch/tune/tables/default.json")


def test_load_active_table_missing_is_silent_and_corrupt_warns(monkeypatch, tmp_path):
    monkeypatch.setenv(t_table.ENV_VAR, str(tmp_path / "absent.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t_table.load_active_table() is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(t_table.ENV_VAR, str(bad))
    with pytest.warns(RuntimeWarning, match="ignoring unusable tuning table"):
        assert t_table.load_active_table() is None
    bad.write_text(json.dumps({"schema": 7, "entries": []}))
    with pytest.warns(RuntimeWarning, match="schema"):
        assert t_table.load_active_table() is None


def test_device_kind_normalises_the_card_name(monkeypatch):
    assert t_table.device_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: " NVIDIA H100 80GB HBM3 ")
    assert t_table.device_kind() == "nvidia-h100-80gb-hbm3"


# --- the cycle model and tile ranking ---------------------------------------------------

GRID = [(m, k, n) for m in (1, 30, 64, 100, 512) for k in (64, 300, 4096) for n in (128, 1408)]


@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
def test_rank_plans_and_choose_tile_equal_the_reference(elem_bytes):
    cands = [(tm, tk, tn) for tm in (8, 64, 128) for tk in (64, 128, 256) for tn in (128, 256)]
    for m, k, n in GRID:
        assert t_tiling.rank_plans(t_engine.OPOPE_16x16_FP16, m, k, n, cands,
                                   elem_bytes=elem_bytes, top_k=len(cands)) == \
            j_tiling.rank_plans(j_engine.OPOPE_16x16_FP16, m, k, n, cands,
                                elem_bytes=elem_bytes, top_k=len(cands))
        tp = t_tiling.choose_tile(t_engine.OPOPE_16x16_FP16, m, k, n, elem_bytes=elem_bytes)
        jp = j_tiling.choose_tile(j_engine.OPOPE_16x16_FP16, m, k, n, elem_bytes=elem_bytes)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("p", [4, 16])
def test_simulate_gemm_equals_the_reference(p):
    t_cfg, j_cfg = t_engine.EngineConfig(p=p), j_engine.EngineConfig(p=p)
    for m, k, n in GRID:
        assert dataclasses.asdict(t_engine.simulate_gemm(t_cfg, m, k, n)) == \
            dataclasses.asdict(j_engine.simulate_gemm(j_cfg, m, k, n))
    small = t_engine.EngineConfig(p=2)
    assert t_engine.simulate_gemm_cycle_accurate(small, 8, 16, 8).total_cycles == \
        j_engine.simulate_gemm_cycle_accurate(j_engine.EngineConfig(p=2), 8, 16, 8).total_cycles


# --- workload harvest --------------------------------------------------------------------

@pytest.mark.parametrize("arch,policy", [("chatglm3-6b", None), ("deepseek-moe-16b", None),
                                         ("chatglm3-6b", "mlp_q8")],
                         ids=["chatglm3-6b", "deepseek-moe-16b", "chatglm3-6b-q8"])
def test_harvest_equals_the_reference_at_published_widths(arch, policy):
    t_be = mlp_q8_policy() if policy else None
    j_be = j_mlp_q8_policy() if policy else None
    got = t_capture.harvest_model_shapes(arch, batch=2, seq=64, backend=t_be)
    want = j_capture.harvest_model_shapes(arch, batch=2, seq=64, backend=j_be)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert got  # both saw the layers' GEMMs


def test_capture_records_and_computes_nothing():
    """On ``meta`` tensors a captured call computes nothing; on real ones it
    is recorded and computes as always."""
    meta = torch.device("meta")
    a = torch.randn(3, 5, 8)
    b = torch.randn(8, 16)
    with ops.capture_shapes() as outer, t_capture.capture_gemm_shapes() as shapes:
        out = ops.matmul(a.to(meta), b.to(meta), epilogue="silu")
        gout = ops.grouped_matmul(torch.empty(2, 4, 8, device=meta),
                                  torch.empty(2, 8, 6, device=meta), backend="q8")
        real = ops.matmul(a, b)
    assert out.shape == (3, 5, 16) and out.device.type == "meta"
    assert gout.shape == (2, 4, 6) and gout.dtype == torch.float32 and gout.is_meta
    assert outer == [("dense", 15, 8, 16, 0, "float32"), ("grouped", 4, 8, 6, 2, "float32"),
                     ("dense", 15, 8, 16, 0, "float32")]
    assert [tuple(s) for s in shapes] == [("dense", 15, 8, 16, 0, "float32"),
                                          ("grouped", 4, 8, 6, 2, "float32")]
    want = (a.reshape(15, 8) @ b).reshape(3, 5, 16)
    torch.testing.assert_close(real, want, rtol=1e-5, atol=1e-5)
    with ops.capture_shapes() as recs:
        greal = ops.grouped_matmul(torch.ones(2, 4, 8), torch.ones(2, 8, 6))
    assert recs == [("grouped", 4, 8, 6, 2, "float32")] and torch.equal(greal,
                                                                        torch.full((2, 4, 6), 8.))
    torch.testing.assert_close(ops.matmul(a, b), want, rtol=1e-5, atol=1e-5)


def test_capture_stays_in_its_thread():
    """A capture open in one thread neither records nor changes the GEMMs
    another thread runs."""
    a = torch.randn(4, 8)
    b = torch.randn(8, 16)
    started, release = threading.Event(), threading.Event()
    seen = []

    def harvest():
        with ops.capture_shapes() as recs:
            ops.matmul(torch.empty(2, 8, device="meta"), torch.empty(8, 4, device="meta"))
            started.set()
            release.wait(30)
        seen.extend(recs)

    t = threading.Thread(target=harvest)
    t.start()
    try:
        assert started.wait(30)
        out = ops.matmul(a, b)  # while the other thread's capture is open
    finally:
        release.set()
        t.join(30)
    torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)
    assert seen == [("dense", 2, 8, 4, 0, "float32")]


# --- retune seams ------------------------------------------------------------------------

def _lookup_sequence():
    """(m, k, n, itemsize, family, groups, backend) lookups: misses, a hit, a
    long miss streak."""
    seq = [(4, 256, 512, 2, "dense", 0, "cuda")] * 2
    seq += [(m, 512, 256, 2, "dense", 0, "cuda") for m in range(1, 8)]
    seq += [(m, 256, 128, 2, "grouped", 8, "cuda") for m in (1, 2, 3)]
    seq += [(4, 256, 512, 2, "dense", 0, "cuda")]
    seq += [(m, 1024, 256, 1, "dense", 0, "cuda_q8") for m in range(9, 17)]
    return seq


def _events(mod, kind):
    return [{k: v for k, v in e.items() if k not in ("ts", "t", "time")}
            for e in mod.recent_events(1000, kind=kind)]


def test_miss_streak_counters_and_events_equal_the_reference():
    j_ops.clear_tile_cache()
    j_ops.reset_tile_cache_stats()
    seen = {"t": [], "j": []}
    for side, mod in (("t", ops), ("j", j_ops)):
        mod.on_miss_streak(None, threshold=3)
        for m, k, n, itemsize, family, groups, backend in _lookup_sequence():
            mod._tile_for(m, k, n, itemsize, family=family, groups=groups, backend=backend)
        seen[side] = mod.tile_cache_stats()
    assert {k: v for k, v in seen["t"].items()} == {k: v for k, v in seen["j"].items()}
    t_snap, j_snap = tobs.snapshot()["counters"], jobs.snapshot()["counters"]
    for name in ("tile.lookups", "tune.retune_candidates"):
        assert t_snap[name] == j_snap[name], name
    assert _events(tobs, "retune_candidate") == _events(jobs, "retune_candidate")
    assert len(_events(tobs, "retune_candidate")) == 5
    # A callback replaces the default hook; its exceptions are swallowed.
    got = []
    ops.reset_tile_cache_stats()
    ops.on_miss_streak(lambda key, streak: got.append((key, streak)) or 1 / 0, threshold=2)
    ops._tile_for(77, 64, 64, 2, family="dense", backend="cuda")
    ops._tile_for(78, 64, 64, 2, family="dense", backend="cuda")
    assert got == [(("cuda", "dense", 78, 64, 64, 0, 2), 2)]
    with pytest.raises(ValueError):
        ops.on_miss_streak(None, threshold=0)


def _observations():
    key_a = ("cuda", "dense", 4, 4096, 4096, 0, 2)
    key_b = ("cuda_q8", "grouped", 30, 2048, 1408, 64, 1)
    seq = [(key_a, 0.8, "tuned"), (key_a, 0.3, "tuned"), (key_b, 0.5, "tuned")]
    seq += [(key_a, f, "tuned") for f in (0.2, 0.25, 0.1, 0.39, 0.2, 0.1)]
    seq += [(key_a, 0.1, "heuristic"), (key_a, 0.1, "tuned"), (key_b, 0.1, "tuned")]
    seq += [(key_b, f, "tuned") for f in (0.2, 0.2, 0.05)]
    return seq


def test_util_gap_counters_and_events_equal_the_reference():
    j_ops.reset_tile_cache_stats()
    for mod in (ops, j_ops):
        mod.on_util_gap(None, threshold=0.5, streak=2)
        for key, fraction, source in _observations():
            mod._note_util_observation(key, fraction, source)
    t_snap, j_snap = tobs.snapshot()["counters"], jobs.snapshot()["counters"]
    for name in ("gemm.util_gap_observations", "tune.retune_candidates"):
        assert t_snap[name] == j_snap[name], name
    assert _events(tobs, "retune_candidate") == _events(jobs, "retune_candidate")
    assert _events(tobs, "retune_candidate")  # the gap fired
    with pytest.raises(ValueError):
        ops.on_util_gap(None, threshold=0.0)
    with pytest.raises(ValueError):
        ops.on_util_gap(None, streak=0)


def test_retune_candidate_equals_the_reference():
    key = ("cuda", "grouped", 60, 1408, 2048, 64, 2)
    for mod in (t_retune, importlib.import_module("repro.tune.retune")):
        mod.retune_candidate(key, 16)
        mod.retune_candidate(key, 4, reason="util_gap")
    assert tobs.snapshot()["counters"]["tune.retune_candidates"] == \
        jobs.snapshot()["counters"]["tune.retune_candidates"]
    assert _events(tobs, "retune_candidate") == _events(jobs, "retune_candidate")


def test_observe_step_feeds_the_util_gap_seam_for_tuned_entries():
    rec = dict(shape_family="dense", backend="cuda", family="fp", m=4, k=4096, n=4096, g=0,
               a_dtype="bfloat16", b_dtype="bfloat16", out_dtype="bfloat16")
    key = ("cuda", "dense", 4, 4096, 4096, 0, 2)
    tuned = t_attr.aggregate([t_attr.GemmRecord(**rec, tile_source="tuned", tile_key=key)])
    heur = t_attr.aggregate([t_attr.GemmRecord(**rec, tile_source="heuristic", tile_key=key)])
    fired = []
    ops.on_util_gap(lambda k, s, f: fired.append((k, s)), threshold=0.5, streak=2)
    t_attr.observe_step(tuned, 1e-5)   # the best fraction
    for _ in range(2):
        t_attr.observe_step(tuned, 1e-3)  # 1 % of it
    assert fired == [(key, 2)]
    assert tobs.snapshot()["counters"]["gemm.util_gap_observations"][""] == 2
    t_attr.observe_step(heur, 1e-3)  # a heuristic observation only resets
    assert ops._UTIL_STREAKS == {}


# --- no table: the heuristic plan, exactly ----------------------------------------------

def _main_path_shapes():
    """(family, k, n, g) of both models' GEMMs at published widths (the
    same under their q8 policies, which change the backend, not the shape)."""
    out = set()
    for arch in ("chatglm3-6b", "deepseek-moe-16b"):
        for s in t_capture.harvest_model_shapes(arch, batch=1, seq=64):
            out.add((s.family, s.k, s.n, s.g))
    return sorted(out)


MAIN_MS = (1, 2, 3, 4, 8, 9, 15, 30, 60, 64, 65, 128, 200, 256, 512, 2048)


def test_no_table_resolves_every_main_path_shape_to_plan():
    shapes = _main_path_shapes()
    assert {fam for fam, *_ in shapes} == {"dense", "grouped"} and len(shapes) == 10
    for (family, k, n, g), backend in [(s, be) for s in shapes for be in ("cuda", "cuda_q8")]:
        for m in MAIN_MS:
            got = ops.tile_for(backend, m, k, n, groups=g)
            if backend == "cuda":
                want = (k4._plan if g else k1._plan)(m, n, k, BF16, 0, 0)
            else:
                want = q8k._plan_grouped(g, m, n, k, 0, 0) if g else q8k._plan(m, n, k, 0, 0)
            assert got == want, (backend, family, m, k, n, g)
            assert ops.tile_source(backend, m, k, n, groups=g) == "heuristic"
            assert ops.fusion_source(backend, m, k, n, groups=g) == "default"
    # fp32 operands and misaligned ones take the tile route, as _plan gives them.
    assert ops.tile_for("cuda", 4, 4096, 4096, dtype=torch.float32) == \
        k1._plan(4, 4096, 4096, torch.float32, 0, 0)
    assert ops._tile_for(4, 4096, 4096, 2, "dense", 0, "cuda", aligned=False) == \
        k1._plan(4, 4096, 4096, BF16, 2, 0)


def _cpu_member(monkeypatch, name, spies):
    """Backend ``name`` taking CPU tensors, its members recording the plan
    each kernel call gets and the kernel's own ``_plan`` for the operands."""
    be = ops.backend(name)
    q8 = name == "cuda_q8"

    def spy_kernel(kern, grouped):
        def run(a, b, c=None, *, plan=None, **kw):
            x = getattr(a, "q", a)
            if q8:
                want = (q8k._plan_grouped(x.shape[0], x.shape[1], b.shape[2], x.shape[2], 0, 0)
                        if grouped else q8k._plan(x.shape[0], b.shape[1], x.shape[1], 0, 0))
            else:
                mod = k4 if grouped else k1
                want = mod._plan(x.shape[-2], b.shape[-1], x.shape[-1], x.dtype,
                                 x.data_ptr(), b.data_ptr())
            spies.append((plan, want))
            return kern(a, b, c, plan=plan, **kw)
        return run

    from repro_torch.quant import backends as q8b
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.kernels.opope_grouped import opope_gemm_grouped
    dense = q8b.cuda_q8 if q8 else opope_gemm
    grouped = q8b.cuda_q8_grouped if q8 else opope_gemm_grouped
    monkeypatch.setitem(ops._REGISTRY, name, dataclasses.replace(
        be, device_type=None,
        fn=ops._planned(name, spy_kernel(dense, False), False, q8),
        grouped_fn=ops._planned(name, spy_kernel(grouped, True), True, q8)))


@pytest.mark.parametrize("arch,policy", [("chatglm3-6b", "cuda"), ("deepseek-moe-16b", "cuda"),
                                         ("chatglm3-6b", "mlp_q8"),
                                         ("deepseek-moe-16b", "moe_q8")])
def test_no_table_members_run_the_kernel_plan_in_a_forward(monkeypatch, arch, policy):
    torch.set_num_threads(2)
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="bfloat16")
    spies = []
    _cpu_member(monkeypatch, "cuda", spies)
    _cpu_member(monkeypatch, "cuda_q8", spies)
    backend = {"cuda": "cuda", "mlp_q8": PrecisionPolicy(rules={"mlp": "cuda_q8"},
                                                           default="cuda"),
               "moe_q8": PrecisionPolicy(rules={"moe": "cuda_q8"}, default="cuda")}[policy]
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    with torch.no_grad():
        loss = api.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens}, backend=backend)
    assert torch.isfinite(loss)
    # No plan passed: each kernel runs its own _plan, the path before tuning.
    assert spies and all(plan is None for plan, _ in spies)
    if policy != "cuda":
        assert any(want.bk == 128 for _, want in spies)  # an int8 kernel ran
    assert ops.tile_cache_stats()["hits"] + ops.tile_cache_stats()["misses"] == 0


# --- resolution from a table ------------------------------------------------------------

def test_tuned_entry_serves_and_is_labelled(monkeypatch, tmp_path):
    _active(monkeypatch, tmp_path, [_entry("cuda", "dense", 4, 256, 512, splits=2)])
    want = k1.validate_plan(4, 512, 256, (128, 128, 64), 2)
    assert want != k1._plan(4, 512, 256, BF16, 0, 0)
    assert ops.tile_for("cuda", 4, 256, 512) == want
    assert ops.tile_source("cuda", 4, 256, 512) == "tuned"
    assert ops.tile_source("cuda", 5, 256, 512) == "heuristic"
    assert ops.tile_for("cuda", 4, 256, 512, dtype=torch.float32).route == "tile"  # other width
    spies = []
    _cpu_member(monkeypatch, "cuda", spies)
    x = torch.randn(4, 256).to(BF16)
    w = torch.randn(256, 512).to(BF16)
    with t_attr.capture_gemms() as recs:
        out = ops.matmul(x, w, backend="cuda")
    torch.testing.assert_close(out, k1.opope_gemm_plain(x, w), rtol=0, atol=0)
    assert spies[0][0] == want
    calls = tobs.snapshot()["counters"]["gemm.calls"]
    assert calls == {"backend=cuda,family=fp,fusion=default,shape=dense,tile=tuned": 1}
    assert recs[0].tile_source == "tuned"
    assert recs[0].tile_key == ("cuda", "dense", 4, 256, 512, 0, 2)
    # Cleared, the heuristic returns.
    monkeypatch.delenv(t_table.ENV_VAR)
    ops.clear_tile_cache()
    ops.matmul(x, w, backend="cuda")
    assert spies[-1][0] is None
    assert "backend=cuda,family=fp,fusion=default,shape=dense,tile=heuristic" in \
        tobs.snapshot()["counters"]["gemm.calls"]


def test_tuned_entries_of_the_q8_and_grouped_kernels_serve(monkeypatch, tmp_path):
    _active(monkeypatch, tmp_path, [
        _entry("cuda_q8", "dense", 30, 1024, 256, block=(8, 128, 128), splits=2, dtype="int8"),
        _entry("cuda_q8", "grouped", 30, 2048, 1408, g=64, block=(8, 128, 128), dtype="int8"),
        _entry("cuda", "grouped", 60, 1408, 2048, g=64, block=(64, 128, 64))])
    assert ops.tile_for("cuda_q8", 30, 1024, 256) == \
        q8k.validate_plan(30, 256, 1024, (8, 128, 128), 2)
    got = ops.tile_for("cuda_q8", 30, 2048, 1408, groups=64)
    assert (got.bm, got.stages, got.splits) == (8, 4, 1)
    assert got != q8k._plan_grouped(64, 30, 1408, 2048, 0, 0)
    got = ops.tile_for("cuda", 60, 1408, 2048, groups=64)
    assert (got.bm, got.stages) == (64, 4)
    assert all(ops.tile_source(*a, **kw) == "tuned" for a, kw in (
        (("cuda_q8", 30, 1024, 256), {}), (("cuda_q8", 30, 2048, 1408), {"groups": 64}),
        (("cuda", 60, 1408, 2048), {"groups": 64})))
    # A grouped entry never serves the dense cell of the same (M, K, N).
    assert ops.tile_source("cuda_q8", 30, 2048, 1408) == "heuristic"


ILLEGAL = {
    "uncompiled tile": _entry("cuda", "dense", 4, 256, 512, block=(96, 128, 64)),
    "split over the counters": _entry("cuda", "dense", 4, 256, 128 * 67, splits=2,
                                      block=(64, 128, 64)),
    "empty split": _entry("cuda", "dense", 4, 256, 512, splits=8),
    "split of K4": _entry("cuda", "grouped", 60, 1408, 2048, g=64, splits=2),
    "split of K5": _entry("cuda_q8", "grouped", 30, 2048, 1408, g=64, block=(8, 128, 128),
                          splits=2, dtype="int8"),
    "K1 tile on K2": _entry("cuda_q8", "dense", 4, 1024, 256, block=(64, 128, 64), dtype="int8"),
}


@pytest.mark.parametrize("what", sorted(ILLEGAL))
def test_illegal_entry_warns_and_the_heuristic_serves(monkeypatch, tmp_path, what):
    e = ILLEGAL[what]
    _active(monkeypatch, tmp_path, [e])
    k = e.key
    with pytest.warns(RuntimeWarning, match="violates kernel constraints"):
        got = ops.tile_for(k.backend, k.m, k.k, k.n, groups=k.g)
    assert got == ops.heuristic_tile(k.backend, k.m, k.k, k.n, groups=k.g)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # memoized: no second warning
        assert ops.tile_for(k.backend, k.m, k.k, k.n, groups=k.g) == got
    assert ops._labels(k.backend, k.shape_family, k.m, k.k, k.n, k.g,
                       2 if k.backend == "cuda" else 1)[0] == "heuristic"


def test_other_device_kind_entry_is_inert(monkeypatch, tmp_path):
    _active(monkeypatch, tmp_path, [
        _entry("cuda", "dense", 4, 256, 512, splits=2, device="nvidia-h100-80gb-hbm3"),
        _entry("cuda", "dense", 4, 256, 512, block=(96, 1, 1), device="nvidia-h100-80gb-hbm3")])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ops.tile_for("cuda", 4, 256, 512) == k1._plan(4, 512, 256, BF16, 0, 0)
        assert ops.tile_source("cuda", 4, 256, 512) == "heuristic"


def test_corrupt_table_warns_once_and_the_heuristic_serves(monkeypatch, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("][")
    monkeypatch.setenv(t_table.ENV_VAR, str(bad))
    ops.clear_tile_cache()
    with pytest.warns(RuntimeWarning, match="ignoring unusable tuning table") as rec:
        for m in (1, 2, 3):
            assert ops.tile_for("cuda", m, 256, 512) == k1._plan(m, 512, 256, BF16, 0, 0)
        assert ops.tile_source("cuda", 1, 256, 512) == "heuristic"
    assert len([w for w in rec if "unusable" in str(w.message)]) == 1


def test_entry_for_a_backend_without_a_tile_knob_is_inert(monkeypatch, tmp_path):
    _active(monkeypatch, tmp_path, [_entry("torch", "dense", 4, 256, 512, splits=2)])
    assert ops.tile_source("torch", 4, 256, 512) == "heuristic"
    assert ops.tunable_backends() == ["cuda", "cuda_q8"]


def test_tuned_posthoc_verdict_takes_the_post_hoc_lane(monkeypatch, tmp_path):
    """``fuse_epilogue=False`` for a cell: the backend gets the fp32 product
    and no chain, the chain runs post-hoc, one cast — the same result as a
    backend registered without ``epilogue_fused`` (the conformance suite's
    post-hoc lane)."""
    _active(monkeypatch, tmp_path, [_entry("torch", "dense", 6, 32, 16, fuse=False),
                                    _entry("torch_q8", "dense", 6, 32, 16, dtype="int8",
                                           fuse=False)])
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)).to(BF16)
    row = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    chain = ["silu", ("bias", row)]
    for name in ("torch", "torch_q8"):
        be = ops.backend(name)
        seen = []
        real = be.fn

        def spy(*args, _real=real, _seen=seen, **kw):
            _seen.append(kw)
            return _real(*args, **kw)

        monkeypatch.setattr(be, "fn", spy)
        got = ops.matmul(a, b, backend=name, epilogue=chain)
        assert seen == [{"out_dtype": torch.float32}]
        assert ops.fusion_source(name, 6, 32, 16) == "tuned"
        monkeypatch.setitem(ops._REGISTRY, "_test_posthoc", dataclasses.replace(
            be, name="_test_posthoc", fn=real, epilogue_fused=False))
        want = ops.matmul(a, b, backend="_test_posthoc", epilogue=chain)
        assert torch.equal(got, want)
        fused = ops.matmul(a[:1], b, backend=name, epilogue=chain)  # another cell: fused
        assert len(seen) == 2 and "epilogue" in seen[1]
        assert fused.shape == (1, 3, 16)
    labels = tobs.snapshot()["counters"]["gemm.calls"]
    assert labels["backend=torch,family=fp,fusion=tuned,shape=dense,tile=heuristic"] == 1
    assert labels["backend=_test_posthoc,family=fp,fusion=none,shape=dense,tile=heuristic"] == 1


def test_tile_cache_is_bounded_and_stats_reset():
    ops.clear_tile_cache()
    for m in range(1, ops._TILE_CACHE_CAP + 40):
        ops.tile_for("cuda", m, 128, 128)
    info = ops.tile_cache_info()
    assert info.currsize == ops._TILE_CACHE_CAP
    stats = ops.tile_cache_stats()
    assert stats["misses"] == ops._TILE_CACHE_CAP + 39 and stats["hits"] == 0
    ops.tile_for("cuda", 600 - 61, 128, 128)
    assert ops.tile_cache_stats()["hits"] == 1
    ops.reset_tile_cache_stats()
    assert ops.tile_cache_stats()["misses"] == 0 and ops.tile_cache_info().currsize > 0


def test_quiet_step_scope_skips_the_lookup_counter():
    with t_attr.step_scope(False):
        ops.tile_for("cuda", 4, 128, 128)
    ops.tile_for("cuda", 4, 128, 128)
    assert tobs.snapshot()["counters"]["tile.lookups"] == {"result=hit": 1}


# --- the kernels' plan API ---------------------------------------------------------------

def test_candidate_plans_are_legal_and_hold_the_heuristic():
    for m in (1, 4, 30, 60, 64, 65, 512):
        for k, n in ((4096, 4096), (4096, 256), (13696, 4096), (4096, 13696), (2048, 1408)):
            for cands, heur in (
                    (k1.candidate_plans(m, n, k), k1._plan(m, n, k, BF16, 0, 0)),
                    (k4.candidate_plans(m, n, k), k4._plan(m, n, k, BF16, 0, 0)),
                    (q8k.candidate_plans(m, n, k), q8k._plan(m, n, k, 0, 0)),
                    (q8k.candidate_plans(m, n, k, grouped=True),
                     q8k._plan_grouped(64, m, n, k, 0, 0))):
                assert heur in cands
                assert len(set(cands)) == len(cands)
                for p in cands:
                    assert p.route == "sm90" and 1 <= p.splits <= len(p.k_bounds) - 1
                    assert p.splits == 1 or p.tiles <= k1._N_COUNTERS
                    assert all(lo < hi for lo, hi in zip(p.k_bounds, p.k_bounds[1:]))
    assert {(p.config, p.splits) for p in k1.candidate_plans(4, 4096, 4096)} == \
        {(c, s) for c in (0, 1) for s in k1.SPLIT_LADDER}
    assert k1.candidate_plans(4, 4096, 4096, dtype=torch.float32) == []
    assert q8k.candidate_plans(4, 100, 4096) == []  # N not a multiple of 16


def test_validate_plan_refusals():
    with pytest.raises(ValueError, match="not a compiled tile"):
        k1.validate_plan(4, 512, 256, (32, 128, 64))
    with pytest.raises(ValueError, match="would be empty"):
        k1.validate_plan(4, 512, 256, (64, 128, 64), 5)
    with pytest.raises(ValueError, match="split-K counters"):
        k1.validate_plan(512, 4096, 4096, (128, 128, 64), 2)
    with pytest.raises(ValueError, match="does not take"):
        k1.validate_plan(4, 512, 256, (64, 128, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        k1.validate_plan(4, 512, 256, (64, 128, 64), aligned=False)
    with pytest.raises(ValueError, match="never splits"):
        k1.validate_plan(4, 512, 256, k1._TILE, 2)
    with pytest.raises(ValueError, match="never splits"):
        k4.validate_plan(4, 512, 256, (64, 128, 64), 2)
    with pytest.raises(ValueError, match="never splits"):
        q8k.validate_plan(4, 512, 256, (8, 128, 128), 2, grouped=True)
    with pytest.raises(ValueError, match="not a compiled tile"):
        q8k.validate_plan(4, 512, 256, (64, 128, 64))
    assert k1.validate_plan(4, 512, 256, k1._TILE).route == "tile"


def test_forced_illegal_plan_raises_on_the_cpu_too():
    a = torch.randn(4, 256).to(BF16)
    b = torch.randn(256, 512).to(BF16)
    bad = k1.Plan("sm90", 0, 64, 128, 64, 8, 8, 1, 4, ())
    with pytest.raises(ValueError, match="empty"):
        k1.opope_gemm(a, b, plan=bad)
    good = k1.validate_plan(4, 512, 256, (128, 128, 64), 4)
    torch.testing.assert_close(k1.opope_gemm(a, b, plan=good), k1.opope_gemm_plain(a, b))
    with pytest.raises(ValueError, match="never splits"):
        k4.opope_gemm_grouped(a[None], b[None], plan=good)
    aq, bq = torch.zeros(4, 256, dtype=torch.int8), torch.zeros(256, 512, dtype=torch.int8)
    sa, sb = torch.ones(4, 1), torch.ones(1, 512)
    with pytest.raises(ValueError, match="not a compiled tile"):
        q8k.opope_gemm_q8(aq, sa, bq, sb, plan=good)
    with pytest.raises(ValueError, match="never splits"):
        q8k.opope_gemm_q8_grouped(aq[None], sa[None], bq[None], sb[None],
                                  plan=q8k.validate_plan(4, 512, 256, (8, 128, 128), 2))


# --- the search, with the timer stubbed -------------------------------------------------

def _stub_search(monkeypatch, us_of):
    """The search on the CPU: no device, a runner that hands the plan to the
    timer, and a timer that reads ``us_of(plan)`` (or the probe's tags)."""
    timed = []
    monkeypatch.setattr(search, "_tuning_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(search, "_make_runner", lambda backend, shape, seed=0:
                        ((lambda plan: plan), 20))
    monkeypatch.setattr(search, "_make_epilogue_runners",
                        lambda backend, shape, plan, seed=0: ("fused", "posthoc", 20))

    def timer(run, *, iters, warmup, calls):
        timed.append(run)
        return us_of(run)

    monkeypatch.setattr(search, "median_time_us", timer)
    return timed


@pytest.mark.parametrize("backend,shape", [
    ("cuda", t_table.GemmShape("dense", 4, 4096, 4096, 0, "bfloat16")),
    ("cuda", t_table.GemmShape("grouped", 30, 2048, 1408, 64, "bfloat16")),
    ("cuda_q8", t_table.GemmShape("dense", 4, 13696, 4096, 0, "bfloat16")),
    ("cuda_q8", t_table.GemmShape("grouped", 60, 1408, 2048, 64, "bfloat16")),
], ids=["k1", "k4", "k2", "k5"])
def test_tune_shape_measures_the_heuristic_and_picks_the_minimum(monkeypatch, backend, shape):
    heur = ops.heuristic_tile(backend, shape.m, shape.k, shape.n, groups=shape.g)
    cands = search.candidate_blocks(backend, shape)

    def us_of(run):
        if run in ("fused", "posthoc"):
            return {"fused": 9.0, "posthoc": 7.0}[run]
        # the heuristic is slow, the last candidate fastest
        return 50.0 if run == heur else 10.0 + cands.index(run) * 0 - 0.01 * cands.index(run)

    timed = _stub_search(monkeypatch, us_of)
    entry, results = search.tune_shape(backend, shape)
    plans = [r for r in timed if r not in ("fused", "posthoc")]
    assert set(plans) == set(cands) and heur in plans
    assert sum(r.is_heuristic for r in results) == 1
    best = min(results, key=lambda r: r.us)
    assert entry.us == best.us <= next(r.us for r in results if r.is_heuristic)
    want = max((p for p in cands if p != heur), key=cands.index)
    assert (entry.block, entry.splits) == ((want.bm, want.bn, want.bk), want.splits)
    assert entry.fuse_epilogue is False  # post-hoc timed faster
    assert entry.key.dtype == ("int8" if backend == "cuda_q8" else "bfloat16")
    assert entry.key.device_kind == "cpu"
    assert all(r.modeled_cycles is None for r in results) and entry.modeled_cycles is None
    # The entry loads back and serves the timed winner's plan.
    assert timed[-2:] == ["fused", "posthoc"]


@pytest.mark.parametrize("backend,shape", [
    ("cuda", t_table.GemmShape("dense", 4, 4096, 4096, 0, "bfloat16")),
    ("cuda_q8", t_table.GemmShape("grouped", 30, 2048, 1408, 64, "bfloat16")),
], ids=["k1", "k5"])
def test_tune_shape_times_every_plan_and_ties_go_to_the_first(monkeypatch, backend, shape):
    timed = _stub_search(monkeypatch, lambda run: 5.0)
    entry, results = search.tune_shape(backend, shape, probe_epilogue=False)
    heur = ops.heuristic_tile(backend, shape.m, shape.k, shape.n, groups=shape.g)
    cands = search.candidate_blocks(backend, shape)
    assert timed == cands and heur in timed  # every legal plan, once, in list order
    assert len({(p.bm, p.bn, p.bk) for p in timed}) == 2  # both compiled tiles
    assert sum(r.is_heuristic for r in results) == 1
    assert entry.fuse_epilogue is None
    # Ties go to the first measured plan, as the reference's min.
    assert (entry.block, entry.splits) == ((timed[0].bm, timed[0].bn, timed[0].bk),
                                           timed[0].splits)


def test_tune_workload_fills_a_table_that_serves(monkeypatch, tmp_path):
    shapes = [t_table.GemmShape("dense", 4, 256, 512, 0, "bfloat16"),
              t_table.GemmShape("grouped", 30, 256, 128, 8, "bfloat16")]
    _stub_search(monkeypatch, lambda run: 3.0 if run not in ("fused", "posthoc")
                 and run.bm == 128 else 4.0)
    lines = []
    table = search.tune_workload(shapes, backends=["cuda", "cuda_q8"], log=lines.append)
    assert len(table) == 4 and len(lines) == 4 and "candidates timed" in lines[0]
    path = tmp_path / "tuned.json"
    table.save(str(path))
    monkeypatch.setenv(t_table.ENV_VAR, str(path))
    ops.clear_tile_cache()
    assert ops.tile_source("cuda", 4, 256, 512) == "tuned"
    assert ops.tile_for("cuda", 4, 256, 512).bm == 128
    assert ops.tile_source("cuda_q8", 30, 256, 128, groups=8) == "tuned"
    assert ops.fusion_source("cuda", 4, 256, 512) == "tuned"


def test_tune_shape_refusals(monkeypatch):
    shape = t_table.GemmShape("dense", 4, 256, 512, 0, "bfloat16")
    with pytest.raises(ValueError, match=re.escape(
            "backend 'torch' has no tile knob to tune; tunable: ['cuda', 'cuda_q8']")):
        search.tune_shape("torch", shape)
    monkeypatch.setitem(ops._REGISTRY, "_test_knob", dataclasses.replace(
        ops.backend("cuda"), name="_test_knob"))
    with pytest.raises(ValueError, match="registers a tile_fn but the tuner has no kernel "
                                         "dispatch for it"):
        search.tune_shape("_test_knob", shape)
    with pytest.raises(RuntimeError, match="no CPU kernel lane"):
        search.tune_shape("cuda", shape)
    with pytest.raises(ValueError, match="not tunable"):
        search.probe_epilogue_fusion("torch", shape, k1._plan(4, 512, 256, BF16, 0, 0))


# --- the CLI -----------------------------------------------------------------------------

def _flags(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]+", buf.getvalue()))


def test_cli_takes_the_reference_flags_and_refuses_without_a_card(capsys):
    want = _flags(j_launch_tune.main)
    assert want >= {"--shapes", "--grouped", "--arch", "--batch", "--seq", "--dtype",
                    "--backends", "--table", "--fresh", "--top-k", "--iters", "--warmup",
                    "--list-backends"}
    # Every reference flag but --top-k: the port times every plan, no model prunes.
    got = _flags(t_launch_tune.main)
    assert got >= want - {"--top-k"} and "--top-k" not in got
    args = t_launch_tune._parser().parse_args([
        "--shapes", "4x4096x4096", "512x13696x4096", "--grouped", "64x30x2048x1408",
        "--arch", "chatglm3-6b", "--arch", "deepseek-moe-16b", "--batch", "2", "--seq", "64",
        "--dtype", "bfloat16", "--backends", "cuda", "cuda_q8", "--table", "t.json",
        "--fresh", "--iters", "5", "--warmup", "2"])
    assert (args.shapes, args.grouped, args.arch, args.batch, args.seq, args.backends,
            args.table, args.fresh, args.iters, args.warmup) == (
        ["4x4096x4096", "512x13696x4096"], ["64x30x2048x1408"],
        ["chatglm3-6b", "deepseek-moe-16b"], 2, 64, ["cuda", "cuda_q8"], "t.json", True, 5, 2)
    assert t_launch_tune._parse_grouped("64x30x2048x1408", "bfloat16") == \
        t_table.GemmShape("grouped", 30, 2048, 1408, 64, "bfloat16")
    with pytest.raises(SystemExit, match="MxKxN"):
        t_launch_tune._parse_dense("4x4096", "bfloat16")
    with pytest.raises(SystemExit, match="CUDA device"):
        t_launch_tune.main(["--shapes", "4x4096x4096"])
    t_launch_tune.main(["--list-backends"])
    assert "['cuda', 'cuda_q8']" in capsys.readouterr().out
