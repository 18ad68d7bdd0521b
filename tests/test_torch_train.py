"""The port's training path against the JAX reference, on the CPU: AdamW and
its schedule, the Markov data pipeline, the train step of a dense and of an
MoE decoder (deepseek-moe-16b, both dispatches), each also under a q8
policy (``mlp_q8_policy()``, ``{"moe": "q8"}``), the loop (its telemetry
and watchdog), the MoE parameter layout, the two command lines, and what
training refuses (a requant policy on a q8 role; the pre-quantized lane).

Tolerances: the optimizer gets identical numpy parameters, gradients and
state on both sides, so its fp32 results must agree to ``1e-6 *
max(1, max|want|)`` (the reference's elementwise arithmetic, op for op; only
the global norm's sum order over leaves differs) and its bf16 results to
one bf16 ulp of the value (a 1-ulp fp32 difference may round the other
way). Train-step losses: ``1e-4 * max(1, |want|)``, as the model tests
(fp32 sums in other orders; AdamW's first step moves each weight by about
``lr * sign(g)``, so a near-zero gradient of the other sign changes a
weight by ``2 * lr``, but it changes the loss only to second order).
"""

import dataclasses
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.data import MarkovLMDataset as JMarkov
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.quant import PrecisionPolicy as JPolicy
from repro.quant import mlp_q8_policy as j_mlp_q8_policy
from repro.train import loop as jloop
from repro_torch import obs as tobs
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy, tensor_from_numpy
from repro_torch.data import MarkovLMDataset, Prefetcher, make_batch_fn
from repro_torch.launch import stats as t_stats
from repro_torch.launch import train as t_launch
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw
from repro_torch.quant import PrecisionPolicy, mlp_q8_policy
from repro_torch.train import loop as tloop


@pytest.fixture(autouse=True)
def _port_telemetry():
    tobs.reset()
    tobs.clear_events()
    yield
    tobs.reset()
    tobs.clear_events()


@pytest.fixture(autouse=True)
def _few_threads():
    # Two torch threads for every case here. The tiny models' steps are
    # mostly thread synchronisation: on a shared 8-core CPU a step of the
    # watchdog case took 100-550 ms at 8 threads and 18-65 ms at 2, and at
    # 8 the steps' own spread reaches the injected stall's size.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, scale=1e-4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(1.0, float(np.abs(want).max())))


# --- AdamW ---------------------------------------------------------------------


def _tree(rng, dtype):
    """A parameter-like tree (matrices, vectors, a list of blocks) of numpy
    arrays; the same keys in sorted order, so both packages walk one order."""
    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)
    return {"a_mat": r(6, 5), "b_vec": r(5), "blocks": [{"w": r(4, 3), "z_scale": r(3)},
                                                        {"w": r(4, 3), "z_scale": r(3)}]}


def _to_torch(tree):
    return jax.tree.map(lambda x: tensor_from_numpy(x, "cpu"), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= ulp + 1e-30)


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("clip_norm", [0.5, None])
def test_apply_updates_matches_jax_on_identical_inputs(param_dtype, moment_dtype, clip_norm):
    rng = np.random.default_rng(0)
    pdt = jnp.bfloat16 if param_dtype == "bfloat16" else np.float32
    params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, pdt)), _tree(rng, np.float32))
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
               clip_norm=clip_norm, moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jadamw.init_opt_state(jp, jcfg), tadamw.init_opt_state(tp, tcfg)
    for step in range(3):
        grads = jax.tree.map(lambda x: np.asarray(jnp.asarray(x * (step + 1), pdt)),
                             _tree(rng, np.float32))
        jp, js, jm = jadamw.apply_updates(jp, _to_jax(grads), js, jcfg)
        tp, ts, tm = tadamw.apply_updates(tp, _to_torch(grads), ts, tcfg)
        assert int(ts.step) == int(js.step) == step + 1
        _close(tm["lr"], jm["lr"], 1e-6)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        for trees in ((tp, jp, param_dtype), (ts.mu, js.mu, moment_dtype),
                      (ts.nu, js.nu, moment_dtype)):
            for got, want in zip(jax.tree.leaves(trees[0]), jax.tree.leaves(trees[1])):
                assert got.dtype == {"float32": torch.float32,
                                     "bfloat16": torch.bfloat16}[trees[2]]
                if trees[2] == "bfloat16":
                    _bf16_close(_np(got), _np(want))
                else:
                    _close(_np(got), _np(want), 1e-6)


def test_decay_applies_to_matrices_only():
    params = {"m": torch.ones(3, 3), "v": torch.ones(3)}
    grads = {"m": torch.zeros(3, 3), "v": torch.zeros(3)}
    cfg = tadamw.AdamWConfig(peak_lr=1.0, warmup_steps=0, total_steps=10, weight_decay=0.5,
                             clip_norm=None)
    tadamw.apply_updates(params, grads, tadamw.init_opt_state(params, cfg), cfg)
    assert torch.all(params["m"] < 1.0) and torch.equal(params["v"], torch.ones(3))


def test_cosine_lr_matches_jax():
    for cfg in (dict(peak_lr=3e-3, warmup_steps=10, total_steps=200),
                dict(peak_lr=1.0, warmup_steps=0, total_steps=1, min_lr_frac=0.0)):
        jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
        for s in (0, 1, 5, 10, 11, 100, 199, 200, 250):
            _close(tadamw.cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32)),
                   jadamw.cosine_lr(jcfg, jnp.int32(s)), 1e-6)


# --- data ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_markov_batches_are_bitwise_the_references(seed):
    ours, ref = MarkovLMDataset(256, 24, 3, seed=seed), JMarkov(256, 24, 3, seed=seed)
    for step in (0, 1, 5, 1000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    batch = make_batch_fn(ours, "cpu")(5)
    assert batch["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["labels"].numpy(), ref.batch_at(5)["labels"])


def test_prefetcher_yields_steps_in_order():
    ds = MarkovLMDataset(64, 8, 2, seed=3)
    fn = make_batch_fn(ds, "cpu")
    pf = Prefetcher(fn, start_step=4, depth=2)
    try:
        for want in range(4, 10):
            step, batch = pf.get()
            assert step == want
            assert torch.equal(batch["tokens"], fn(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# --- the train step and the loop ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = j_get_config("chatglm3-6b").reduced()
    tcfg = t_get_config("chatglm3-6b").reduced()
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("policy", ["fp", "q8"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_losses_match_jax_over_3_steps(grad_accum, policy):
    """``policy="q8"``: ``mlp_q8_policy()`` on both sides (the MLP's forward
    GEMMs int8, on ``xla_q8`` and ``torch_q8``; their backward full
    precision)."""
    jcfg, tcfg, params = _model()
    jcfg = dataclasses.replace(jcfg, grad_accum=grad_accum)
    tcfg = dataclasses.replace(tcfg, grad_accum=grad_accum)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    q8 = policy == "q8"
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**opt), donate=False,
                                  policy=j_mlp_q8_policy() if q8 else None)
    tstep = tloop.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                  policy=mlp_q8_policy() if q8 else None)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(tcfg, params, "cpu")
    js = jadamw.init_opt_state(jp, jadamw.AdamWConfig(**opt))
    ts = tadamw.init_opt_state(tp, tadamw.AdamWConfig(**opt))
    ds = JMarkov(tcfg.vocab, 16, 4, seed=2)
    for step in range(3):
        host = ds.batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in host.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v.astype(np.int64))
                                    for k, v in host.items()})
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"])


def _run_port(steps, batch_fn=None, **loop_kw):
    _, tcfg, _ = _model()
    ds = MarkovLMDataset(tcfg.vocab, 32, 8, seed=0)
    opt = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=steps)
    loop = tloop.TrainLoopConfig(total_steps=steps, log_every=0, **loop_kw)
    return tloop.train(tcfg, opt, loop, batch_fn or make_batch_fn(ds, "cpu"), device="cpu",
                       log=lambda *_: None)


def test_train_loss_falls_and_step_events_match_the_references():
    res = _run_port(24)
    assert len(res.losses) == 24 and res.final_step == 24 and res.resumed_from is None
    assert np.mean(res.losses[-3:]) < res.losses[0] - 0.5  # ln(256) = 5.55 at the start
    ours = tobs.recent_events(100, kind="train_step")
    assert [e["step"] for e in ours] == list(range(24))
    snap = tobs.snapshot()
    assert snap["histograms"]["train.step_seconds"][""]["count"] == 24

    # The reference's loop on the same config for 2 steps: the same event
    # fields; equal values where they do not derive from wall time.
    jcfg, tcfg, params = _model()
    jobs.clear_events()
    jds = JMarkov(jcfg.vocab, 32, 8, seed=0)
    jloop.train(jcfg, jadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=2),
                jloop.TrainLoopConfig(total_steps=2, log_every=0),
                lambda s: {k: jnp.asarray(v) for k, v in jds.batch_at(s).items()},
                params=jax.tree.map(jnp.asarray, params), log=lambda *_: None)
    theirs = jobs.recent_events(10, kind="train_step")
    tobs.clear_events()
    tloop.train(tcfg, tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=2),
                tloop.TrainLoopConfig(total_steps=2, log_every=0),
                make_batch_fn(MarkovLMDataset(tcfg.vocab, 32, 8, seed=0), "cpu"),
                params=params_from_numpy(tcfg, params, "cpu"), log=lambda *_: None)
    ours = tobs.recent_events(10, kind="train_step")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert (a["step"], a["tokens"]) == (b["step"], b["tokens"])
        _close(a["loss"], b["loss"])
        assert a["roofline_frac"] > 0 and a["gflops_per_sec"] > 0


def test_watchdog_flags_an_injected_stall():
    _, tcfg, _ = _model()
    base = make_batch_fn(MarkovLMDataset(tcfg.vocab, 8, 2, seed=0), "cpu")

    def slow_batch(step):
        if step == 9:
            time.sleep(1.0)  # synthetic stall
        return base(step)

    res = _run_port(10, batch_fn=slow_batch, watchdog_factor=3.0)
    assert res.straggler_steps >= 1
    assert any(e["step"] == 9 for e in tobs.recent_events(50, kind="straggler"))


def test_watchdog_needs_five_steps_and_a_factor():
    wd = tloop._Watchdog(3.0)
    assert not any(wd.observe(1.0) for _ in range(5))
    assert not wd.observe(2.9) and wd.observe(10.0) and wd.flagged == 1


def test_launch_train_and_stats_train_run_on_the_cpu(tmp_path, capsys):
    res = t_launch.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
                         "--steps", "6", "--batch", "2", "--seq", "16"])
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    out = tmp_path / "snap.json"
    tobs.reset()
    t_stats.main(["train", "--out", str(out), "--", "--arch", "chatglm3-6b", "--reduced",
                  "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    snap = json.loads(out.read_text())
    assert snap["histograms"]["train.step_seconds"][""]["count"] == 3
    assert snap["histograms"]["span.seconds"]["name=stats.train"]["count"] == 1


# --- MoE training (deepseek-moe-16b, reduced) ---------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_model():
    jcfg = j_get_config("deepseek-moe-16b").reduced()
    tcfg = t_get_config("deepseek-moe-16b").reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(functools.partial(japi.init_params, jcfg))(jax.random.key(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("policy", ["fp", "q8"])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_train_step_losses_match_jax_over_3_steps(dispatch, policy):
    """``policy="q8"``: ``{"moe": "q8"}`` on both sides (the routed experts
    and the shared MLP int8 in the forward)."""
    jcfg, tcfg, params = _moe_model()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, dispatch=dispatch))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, dispatch=dispatch))
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    q8 = policy == "q8"
    jstep = jloop.make_train_step(jcfg, jadamw.AdamWConfig(**opt), donate=False,
                                  policy=JPolicy(rules={"moe": "q8"}) if q8 else None)
    tstep = tloop.make_train_step(tcfg, tadamw.AdamWConfig(**opt),
                                  policy=PrecisionPolicy(rules={"moe": "q8"}) if q8 else None)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(tcfg, params, "cpu")
    js = jadamw.init_opt_state(jp, jadamw.AdamWConfig(**opt))
    ts = tadamw.init_opt_state(tp, tadamw.AdamWConfig(**opt))
    ds = JMarkov(tcfg.vocab, 16, 4, seed=3)
    for step in range(3):
        host = ds.batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in host.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v.astype(np.int64))
                                    for k, v in host.items()})
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"])
    # The parameters after 3 updates, router and experts included.
    got = params_to_numpy(tcfg, tp)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        _close(x, y)


def test_moe_params_to_numpy_round_trips_the_reference_layout():
    """Router, expert stacks and shared MLP in the reference's
    period-stacked layout, bitwise both ways."""
    _, tcfg, params = _moe_model()
    tcfg = dataclasses.replace(tcfg, n_layers=3)
    jcfg = dataclasses.replace(j_get_config("deepseek-moe-16b").reduced(), n_layers=3)
    params = jax.tree.map(np.asarray, jax.jit(functools.partial(japi.init_params, jcfg))(
        jax.random.key(1)))
    tp = params_from_numpy(tcfg, params, "cpu")
    assert len(tp["blocks"]) == 3
    assert tuple(tp["blocks"][2]["moe"]["w_gate"].shape) == (4, 64, 32)
    back = params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert set(back["blocks"][0]["moe"]) == {"router", "w_gate", "w_up", "w_down", "shared"}
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_launch_train_runs_deepseek_on_the_cpu():
    res = t_launch.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                         "--steps", "8", "--batch", "2", "--seq", "16"])
    assert len(res.losses) == 8 and all(np.isfinite(res.losses))
    events = tobs.recent_events(20, kind="train_step")
    assert [e["step"] for e in events] == list(range(8))


def test_moe_step_events_count_every_parameter_like_the_reference():
    """``model_flops`` over all parameters, as the reference's loop: the
    same event fields and equal non-wall values over 2 steps."""
    jcfg, tcfg, params = _moe_model()
    jobs.clear_events()
    jds = JMarkov(jcfg.vocab, 16, 4, seed=0)
    opt = dict(peak_lr=1e-2, warmup_steps=1, total_steps=2)
    jloop.train(jcfg, jadamw.AdamWConfig(**opt), jloop.TrainLoopConfig(total_steps=2, log_every=0),
                lambda s: {k: jnp.asarray(v) for k, v in jds.batch_at(s).items()},
                params=jax.tree.map(jnp.asarray, params), log=lambda *_: None)
    theirs = jobs.recent_events(10, kind="train_step")
    tobs.clear_events()
    tloop.train(tcfg, tadamw.AdamWConfig(**opt), tloop.TrainLoopConfig(total_steps=2, log_every=0),
                make_batch_fn(MarkovLMDataset(tcfg.vocab, 16, 4, seed=0), "cpu"),
                params=params_from_numpy(tcfg, params, "cpu"), log=lambda *_: None)
    ours = tobs.recent_events(10, kind="train_step")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert (a["step"], a["tokens"]) == (b["step"], b["tokens"])
        _close(a["loss"], b["loss"])
        # The same FLOP count (all parameters): the rates' ratio is the
        # walls' inverse ratio.
        _close(a["gflops_per_sec"] * a["wall_s"], b["gflops_per_sec"] * b["wall_s"], 1e-6)


# --- what training refuses ------------------------------------------------------------


def test_unported_training_paths_raise():
    """A requant policy on a q8-family role is refused up front (the
    reference's gradients through its int8 activation are exactly zero);
    the pre-quantized lane it feeds raises under autograd (serving-only)."""
    _, tcfg, params = _model()
    opt = tadamw.AdamWConfig(total_steps=2)
    for policy in (mlp_q8_policy(requant_scale=0.05),
                   PrecisionPolicy(rules={"mlp": "torch_q8"}, requant={"mlp": 0.05})):
        with pytest.raises(NotImplementedError, match="no gradient"):
            tloop.make_train_step(tcfg, opt, policy=policy)
    # Requant on a role whose backend is fp never writes int8: fine.
    tloop.make_train_step(tcfg, opt, policy=PrecisionPolicy(rules={"mlp": "torch"},
                                                            requant={"mlp": 0.05}))
    tp = params_from_numpy(tcfg, params, "cpu")
    live = jax.tree.map(lambda p: p.detach().requires_grad_(), tp)
    batch = make_batch_fn(MarkovLMDataset(tcfg.vocab, 8, 2), "cpu")(0)
    with pytest.raises(NotImplementedError, match="serving-only"):
        tapi.loss_fn(tcfg, live, batch, backend=mlp_q8_policy(requant_scale=0.05))


@pytest.mark.parametrize("policy", ["q8", "torch_q8", "attn_qkv", "moe"])
def test_q8_policies_train(policy):
    """Every q8 policy without requant trains: one step, finite loss."""
    arch = "deepseek-moe-16b" if policy == "moe" else "chatglm3-6b"
    tcfg = t_get_config(arch).reduced()
    pol = {"attn_qkv": PrecisionPolicy(rules={"attn_qkv": "torch_q8"}),
           "moe": PrecisionPolicy(rules={"moe": "q8"})}.get(policy, policy)
    fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, 8, 2), "cpu")
    res = tloop.train(tcfg, tadamw.AdamWConfig(total_steps=2),
                      tloop.TrainLoopConfig(total_steps=2, log_every=0), fn, device="cpu",
                      policy=pol, log=lambda *_: None)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


def test_training_entry_points_default_to_the_card(monkeypatch):
    _, tcfg, _ = _model()
    opt = tadamw.AdamWConfig(total_steps=2)
    fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, 8, 2), "cpu")
    # The default device is the card; without one the entry points raise.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--arch", "chatglm3-6b", "--reduced", "--steps", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.train(tcfg, opt, tloop.TrainLoopConfig(total_steps=2), fn)
