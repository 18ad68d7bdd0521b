"""How far an MoE model's free-running routing share moves between token draws.

``chip_smoke.py`` 14(i) and 16(i) hold the share of top-k assignments that a
free-running prefill on the kernels makes alike with one on the plain
backend to at least the share that two plain summation orders (fp32 and
fp64 sums) make alike, less ``FREE_ROUTING_MARGIN``, pooled over
``FREE_ROUTING_BATCHES`` prefills of 2 x 64 tokens. This probe runs, for
many token draws (numpy seeds 0, 1, ..., 2 x 64 tokens each; seed 0 is the
draw of the smoke's logits gate), free-running prefills on a family's
full-width weights drawn from seed 0, cut in depth as the smoke cuts them:
the kernels, the plain backend, and the plain backend with each product
taken another way: fp64 sums (the gate's floor), another fp32 order (K
summed as two halves, added after), and cuBLAS's tensor-core product of
the bf16 operands with an fp32 result (a library GEMM). It prints each
draw's shares of assignments made alike with the plain backend; then, per
family, the mean and spread of the gate's difference (floor less kernels)
for one draw and for pools of ``FREE_ROUTING_BATCHES`` consecutive draws,
and the mean difference of each other way (floor less its share).

Needs a CUDA device. Run from the root of a checkout::

    python tools/routing_noise_probe.py --family jamba-v0.1-52b:16 \\
        --family grok-1-314b:4 --draws 48

It prints one JSON line a draw and one summary line a family.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fp32_halves(torch, ep):
    """The plain versions' function with another fp32 summation order:
    each product summed as two halves of K, added after (TF32 off)."""
    from repro_torch.kernels.opope_gemm import full_fp32

    def fn(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        k = a.shape[-1] // 2
        with full_fp32():
            acc = a[..., :k].float() @ b[..., :k, :].float()
            acc = acc + a[..., k:].float() @ b[..., k:, :].float()
        if c is not None:
            acc = acc + (c.float()[:, None, :] if a.ndim == 3 and c.ndim == 2 else c.float())
        acc = ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
        return acc.to(out_dtype or a.dtype)
    return fn


def library(torch, ep):
    """The plain versions' function with cuBLAS's tensor-core product of
    bf16 operands, accumulated and returned in fp32 (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype``); other operands as the plain version."""
    from repro_torch.kernels.opope_gemm import full_fp32

    def fn(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        f32 = torch.float32
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            with full_fp32():
                acc = a.float() @ b.float()
        elif b.ndim == 3:
            acc = torch.bmm(a, b, out_dtype=f32)
        else:
            acc = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
            acc = acc.reshape(*a.shape[:-1], b.shape[-1])
        if c is not None:
            acc = acc + (c.float()[:, None, :] if a.ndim == 3 and c.ndim == 2 else c.float())
        acc = ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
        return acc.to(out_dtype or a.dtype)
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", action="append", required=True,
                    help="NAME:LAYERS, an MoE family and the depth it is cut to")
    ap.add_argument("--draws", type=int, default=48)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("routing_noise_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import epilogue as ep
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod

    print(cs.nvidia_smi(), flush=True)
    kbuild.build_all(["opope_gemm", "opope_grouped"])
    dev = torch.device("cuda")
    pool = cs.FREE_ROUTING_BATCHES
    for spec in args.family:
        name, layers = spec.split(":")
        cfg = dataclasses.replace(get_config(name), n_layers=int(layers))
        if cfg.moe is None:
            raise SystemExit(f"{name} has no MoE layer")
        params, _ = cs._family_params(torch, api, cfg, dev, name)
        t0 = time.perf_counter()
        diffs, by_order = [], {}
        for seed in range(args.draws):
            tokens = torch.from_numpy(
                np.random.default_rng(seed).integers(0, cfg.vocab, (2, 64))).to(dev)
            share, n = cs.free_routing_shares(torch, api, moe_mod, ops, cfg, params, tokens,
                                              {"fp64": cs._fp64_plain(torch, ep),
                                               "halves": fp32_halves(torch, ep),
                                               "library": library(torch, ep)})
            diffs.append(share["fp64"] - share["kernels"])
            for k in ("kernels", "halves", "library"):
                by_order.setdefault(k, []).append(share["fp64"] - share[k])
            print(json.dumps({"family": name, "layers": cfg.n_layers, "seed": seed,
                              "assignments": n, "shares_with_plain": share,
                              "difference": diffs[-1]}), flush=True)
        pooled = [statistics.fmean(diffs[i:i + pool])
                  for i in range(0, len(diffs) - pool + 1, pool)]
        print(json.dumps({
            "family": name, "layers": cfg.n_layers, "draws": len(diffs),
            "mean_difference": statistics.fmean(diffs),
            "sd_difference_one_draw": statistics.stdev(diffs),
            "sd_difference_pool_estimate": statistics.stdev(diffs) / pool ** 0.5,
            "largest_difference_one_draw": max(diffs),
            f"pooled_differences_{pool}_draws": pooled,
            "mean_difference_by_order": {k: statistics.fmean(v) for k, v in by_order.items()},
            "sd_difference_by_order_one_draw": {k: statistics.stdev(v)
                                                for k, v in by_order.items()},
            "margin": cs.FREE_ROUTING_MARGIN,
            "seconds": time.perf_counter() - t0}), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
