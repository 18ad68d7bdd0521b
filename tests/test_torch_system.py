"""End-to-end on the port, on the CPU: train a reduced model through the
whole stack, checkpoint it, restore it and serve from it — the port's
counterpart of ``tests/test_system.py``, with its numbers — and the same
checkpoint read by the reference and served by its engine, token for
token."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data import MarkovLMDataset, make_batch_fn
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainLoopConfig, train


def test_train_then_serve_roundtrip(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the reduced model's step is mostly thread sync at 8
    try:
        cfg = get_config("chatglm3-6b").reduced()
        ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=32, batch=8, seed=0)
        opt = AdamWConfig(peak_lr=1e-2, warmup_steps=20, total_steps=200)
        loop = TrainLoopConfig(total_steps=200, ckpt_every=100, ckpt_dir=str(tmp_path),
                               log_every=0)
        res = train(cfg, opt, loop, make_batch_fn(ds, "cpu"), device="cpu",
                    log=lambda *_: None)
        assert res.losses[-1] < res.losses[0] - 2.0  # learned the Markov stream

        # restore params from the final checkpoint and serve
        step = latest_step(str(tmp_path))
        assert step == 200
        params_like = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt_like = init_opt_state(params_like, AdamWConfig())
        state = restore(str(tmp_path), step, like={"params": params_like, "opt": opt_like},
                        device="cpu")
        eng = ServeEngine(cfg=cfg, params=state["params"], max_len=64,
                          cache_dtype=torch.float32)
        prompt = ds.batch_at(0)["tokens"][:2, :16]
        toks = eng.generate({"tokens": torch.from_numpy(prompt.astype(np.int64))}, 16).numpy()
    finally:
        torch.set_num_threads(n)
    assert toks.shape == (2, 16)
    # a trained model should follow the Markov chain: generated tokens must
    # be among the successors of their predecessors far above chance
    succ = ds._succ
    prev = np.concatenate([prompt[:, -1:], toks[:, :-1]], 1)
    hits = np.mean([toks[i, j] in succ[prev[i, j]] for i in range(2) for j in range(16)])
    assert hits > 0.5, hits  # chance level is branch/vocab = 4/256

    # The same checkpoint, read by the reference and served by its engine.
    jcfg = j_get_config("chatglm3-6b").reduced()
    jparams_like = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    jopt_like = jax.eval_shape(lambda: j_init_opt_state(jparams_like, JAdamWConfig()))
    jstate = jckpt.restore(str(tmp_path), step, like={"params": jparams_like, "opt": jopt_like})
    jeng = JServeEngine(cfg=jcfg, params=jstate["params"], max_len=64, cache_dtype=jnp.float32)
    jtoks = np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)}, 16))
    np.testing.assert_array_equal(toks, jtoks)
