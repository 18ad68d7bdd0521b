"""The port's checkpoints (:mod:`repro_torch.checkpoint`) against the
reference's (:mod:`repro.checkpoint`), on the CPU.

* The reference's own checkpoint tests (``tests/test_substrate.py::
  TestCheckpoint``), ported: round trip, a partial write never resumed, the
  single-flight async writer with its garbage collection, a shape mismatch
  and a missing leaf.
* The files are the reference's: a tree the reference saves (a bf16 leaf
  included) is read by the port, a reduced chatglm3-6b ``{"params", "opt"}``
  the port saves is read by the reference, and for one fp32 numpy tree the
  two packages write byte-equal ``.npy`` files and manifest entries.
* The loop resumes bitwise after an injected failure, and the reference's
  ``test_learns_and_resumes_after_injected_failure`` with its numbers.

Every comparison is exact: a checkpoint moves bits.
"""

import dataclasses
import functools
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import MarkovLMDataset, make_batch_fn
from repro_torch.optim import AdamWConfig, OptState, init_opt_state
from repro_torch.train import TrainLoopConfig, train
from repro_torch.tree import leaves, map_leaves


@pytest.fixture(autouse=True)
def _few_threads():
    # Two torch threads, as tests/test_torch_train.py: the reduced model's
    # steps are mostly thread synchronisation at 8.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(x: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its 16-bit patterns)."""
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _assert_trees_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


# --- the reference's TestCheckpoint, ported -----------------------------------------


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)}}
    tckpt.save(str(tmp_path), 7, tree)
    assert tckpt.latest_step(str(tmp_path)) == 7
    back = tckpt.restore(str(tmp_path), 7, like=tree, device="cpu")
    _assert_trees_equal(back, tree)


def test_partial_write_invisible(tmp_path):
    """A .tmp directory (a crash mid-write) is never resumed."""
    tckpt.save(str(tmp_path), 5, {"a": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "a.npy").write_bytes(b"garbage")
    assert tckpt.latest_step(str(tmp_path)) == 5


def test_async_writer_single_flight(tmp_path):
    w = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        w.save(s, {"x": torch.full((4,), float(s))})
    w.wait()
    assert tckpt.latest_step(str(tmp_path)) == 30
    # GC keeps only the newest `keep`
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000020", "step_00000030"]
    back = tckpt.restore(str(tmp_path), 20, like={"x": torch.empty(4)}, device="cpu")
    assert torch.equal(back["x"], torch.full((4,), 20.0))


def test_async_writer_copies_before_returning_and_surfaces_errors(tmp_path):
    """The device-to-host copy is synchronous: an in-place update after
    ``save`` returns does not reach the file. A write's error surfaces on
    the next ``wait``."""
    x = torch.zeros(4)
    w = tckpt.AsyncCheckpointer(str(tmp_path))
    w.save(1, {"x": x})
    x.add_(1.0)
    w.wait()
    assert torch.equal(tckpt.restore(str(tmp_path), 1, {"x": x}, device="cpu")["x"],
                       torch.zeros(4))
    (tmp_path / "blocked").write_text("a file where the writer wants a directory")
    w2 = tckpt.AsyncCheckpointer(str(tmp_path / "blocked"))
    w2.save(2, {"x": x})
    with pytest.raises(OSError):
        w2.wait()
    w2.wait()  # raised once


def test_restore_shape_mismatch_raises(tmp_path):
    tckpt.save(str(tmp_path), 1, {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), 1, like={"a": torch.empty((3, 3))}, device="cpu")


def test_restore_missing_leaf_raises(tmp_path):
    tckpt.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="b"):
        tckpt.restore(str(tmp_path), 1, like={"a": torch.empty(2), "b": torch.empty(2)},
                      device="cpu")


def test_bf16_leaves_keep_their_bits(tmp_path):
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tckpt.save(str(tmp_path), 1, {"w": x})
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"] == [{"path": "w", "file": "w.npy", "shape": [5, 3],
                                   "dtype": "bfloat16"}]
    back = tckpt.restore(str(tmp_path), 1, {"w": x}, device="cpu")
    _assert_trees_equal(back, {"w": x})


# --- the files are the reference's -----------------------------------------------------


def test_reads_a_tree_the_reference_saves(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"z": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "a": np.arange(5, dtype=np.int32),
            "h": rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16),
            "s": np.float32(2.5)}
    jckpt.save(str(tmp_path), 3, tree)
    like = {"z": {"w": torch.empty(3, 4)}, "a": torch.empty(5, dtype=torch.int32),
            "h": torch.empty(2, 6, dtype=torch.bfloat16), "s": torch.empty(())}
    back = tckpt.restore(str(tmp_path), 3, like, device="cpu")
    assert back["h"].dtype == torch.bfloat16 and back["a"].dtype == torch.int32
    np.testing.assert_array_equal(_bits(back["h"]), tree["h"].view(np.int16))
    np.testing.assert_array_equal(back["z"]["w"].numpy(), tree["z"]["w"])
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    assert back["s"].item() == 2.5


def test_writes_the_references_files_byte_for_byte(tmp_path):
    """One fp32 numpy tree (a bf16 leaf and a 0-d int32 too): the same
    files, byte for byte, and the same manifest."""
    rng = np.random.default_rng(1)
    tree = {"params": {"embed": {"table": rng.standard_normal((7, 4)).astype(np.float32)},
                       "b": rng.standard_normal((3,)).astype(np.float32)},
            "opt": {"step": np.asarray(3, np.int32),
                    "mu": rng.standard_normal((2, 3, 4)).astype(np.float32)},
            "h": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)}
    jckpt.save(str(tmp_path / "j"), 2, tree)
    port_tree = dict(tree, h=torch.from_numpy(tree["h"].view(np.int16)).view(torch.bfloat16))
    tckpt.save(str(tmp_path / "t"), 2, port_tree)
    jd, td = tmp_path / "j" / "step_00000002", tmp_path / "t" / "step_00000002"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name


ARCHS = ["chatglm3-6b", "deepseek-moe-16b"]  # the decoders the port trains


def _reduced_state(arch, n_layers=3):
    """A reduced model at ``n_layers`` layers (so the stacking's layer order
    shows), its parameters from the reference's init and random moments."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), n_layers=n_layers)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), n_layers=n_layers)
    params = jax.tree.map(np.asarray, jax.jit(functools.partial(japi.init_params, jcfg))(
        jax.random.key(0)))
    tp = params_from_numpy(tcfg, params, "cpu")
    gen = torch.Generator().manual_seed(3)
    state = init_opt_state(tp, AdamWConfig())
    state = OptState(torch.tensor(17, dtype=torch.int32),
                     map_leaves(lambda m: torch.randn(m.shape, generator=gen), state.mu),
                     map_leaves(lambda m: torch.rand(m.shape, generator=gen), state.nu))
    return jcfg, tcfg, tp, state


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reference_reads_a_model_state_the_port_saves(tmp_path, arch):
    """A reduced model's parameters and AdamW state in the reference's
    layout (block leaves stacked over layers, MoE expert leaves ``[E, ...]``
    within them, ``opt/.step`` 0-d int32), every leaf equal; and back into
    the port, bitwise."""
    jcfg, tcfg, tp, state = _reduced_state(arch)
    tckpt.save(str(tmp_path), 17, {"params": tp, "opt": state})
    manifest = json.loads((tmp_path / "step_00000017" / "manifest.json").read_text())
    paths = [e["path"] for e in manifest["leaves"]]
    assert paths[0] == "opt/.step" and "opt/.mu/blocks/0/attn/wq/w" in paths
    params_like = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    opt_like = jax.eval_shape(lambda: jadamw.init_opt_state(params_like, jadamw.AdamWConfig()))
    back = jckpt.restore(str(tmp_path), 17, like={"params": params_like, "opt": opt_like})
    assert int(back["opt"].step) == 17
    want = {"params": params_to_numpy(tcfg, tp), "mu": params_to_numpy(tcfg, state.mu),
            "nu": params_to_numpy(tcfg, state.nu)}
    got = {"params": back["params"], "mu": back["opt"].mu, "nu": back["opt"].nu}
    for key in want:
        assert jax.tree.structure(got[key]) == jax.tree.structure(want[key])
        for x, y in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key])):
            np.testing.assert_array_equal(np.asarray(x), y)
    again = tckpt.restore(str(tmp_path), 17, {"params": tp, "opt": state}, device="cpu")
    _assert_trees_equal(again, {"params": tp, "opt": state})


# --- resume -----------------------------------------------------------------------------


def _loop(total, ckpt_dir=None, ckpt_every=4, fail_at_step=None, peak_lr=1e-2, warmup=3,
          arch="chatglm3-6b"):
    cfg = t_get_config(arch).reduced()
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=32, batch=8, seed=0)
    opt = AdamWConfig(peak_lr=peak_lr, warmup_steps=warmup, total_steps=total)
    loop = TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                           log_every=0, fail_at_step=fail_at_step)
    return train(cfg, opt, loop, make_batch_fn(ds, "cpu"), device="cpu", log=lambda *_: None)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_after_a_failure_is_bitwise(tmp_path, arch):
    """12 steps, a checkpoint every 4, a failure at step 10: the resumed run
    (from step 8) ends with the uninterrupted run's parameters and moments,
    bit for bit, and its losses for steps 8..11."""
    whole = _loop(12, arch=arch)
    with pytest.raises(RuntimeError, match="injected failure at step 10"):
        _loop(12, str(tmp_path), fail_at_step=10, arch=arch)
    assert tckpt.latest_step(str(tmp_path)) == 8
    res = _loop(12, str(tmp_path), arch=arch)
    assert res.resumed_from == 8 and len(res.losses) == 4
    assert res.losses == whole.losses[8:]
    _assert_trees_equal({"p": res.params, "o": res.opt_state},
                        {"p": whole.params, "o": whole.opt_state})
    # Saved at 4, 8 and 12; the last is the final state.
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000008", "step_00000012"]
    last = tckpt.restore(str(tmp_path), 12, {"params": res.params, "opt": res.opt_state},
                         device="cpu")
    _assert_trees_equal(last, {"params": res.params, "opt": res.opt_state})


def test_learns_and_resumes_after_injected_failure(tmp_path):
    """The reference's ``TestTrainLoopFaultTolerance`` case with its numbers."""
    with pytest.raises(RuntimeError, match="injected failure"):
        _loop(120, str(tmp_path), ckpt_every=40, fail_at_step=90, warmup=10)
    # restart: resumes from the step-80 checkpoint and finishes
    res = _loop(120, str(tmp_path), ckpt_every=40, warmup=10)
    assert res.resumed_from == 80
    assert res.losses[-1] < 4.0  # learned well below ln(256) = 5.55


def test_resume_refuses_another_configurations_dtype(tmp_path):
    cfg = dataclasses.replace(t_get_config("chatglm3-6b").reduced(), n_layers=1)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=8, batch=2, seed=0)
    opt = AdamWConfig(total_steps=1)
    loop = TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path), log_every=0)
    train(cfg, opt, loop, make_batch_fn(ds, "cpu"), device="cpu", log=lambda *_: None)
    with pytest.raises(ValueError, match="dtype"):
        train(bf16, dataclasses.replace(opt, total_steps=2),
              dataclasses.replace(loop, total_steps=2), make_batch_fn(ds, "cpu"),
              device="cpu", log=lambda *_: None)
