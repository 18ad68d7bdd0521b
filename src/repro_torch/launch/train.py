"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of :mod:`repro.launch.train`: the training loop
(:mod:`repro_torch.train.loop`) on a :class:`~repro_torch.data.MarkovLMDataset`
stream, with the reference's flags and schedule (warmup ``max(10,
steps // 20)``, a log line every ``steps // 20`` steps). Runs on
``--device cuda`` (default) or ``cpu``; ``--reduced`` trains the tiny
same-family config. Parameters are random, drawn from ``--seed``.
``--ckpt-dir D`` checkpoints every ``--ckpt-every`` steps and at the end
(:mod:`repro_torch.checkpoint`, the reference's file format) and resumes
from the newest complete checkpoint in ``D``.
Progress goes through the structured logger (``REPRO_LOG=text|json``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.data import MarkovLMDataset, make_batch_fn
from repro_torch.models import api
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, TrainResult, train


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from its newest step")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not api.takes_token_prompt(cfg):
        raise SystemExit("the train launcher drives LM-family archs")
    device = api.resolve_device(args.device)

    ds = MarkovLMDataset(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=args.seed
    )
    opt = AdamWConfig(
        peak_lr=args.lr, warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps,
    )
    loop = TrainLoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        log_every=max(1, args.steps // 20),
    )
    log = obs.get_logger("train")
    res = train(
        cfg, opt, loop, make_batch_fn(ds, device),
        generator=torch.Generator(device=device).manual_seed(args.seed), device=device,
        log=log.raw,
    )
    log.info(
        "done", loss_first=res.losses[0] if res.losses else None,
        loss_last=res.losses[-1] if res.losses else None,
        stragglers=res.straggler_steps, resumed_from=res.resumed_from,
    )
    return res


if __name__ == "__main__":
    main()
