"""Device time of K1's and K4's ``tile`` routes, for comparing two checkouts.

The tile route (``csrc/opope_tile.cuh``) runs fp32 GEMMs (training's fp32
cotangent products among them), 2-byte operands TMA cannot describe, and
since the dtype rule of ``kernels/opope_gemm.py`` the 8-bit floats and
mixed pairs. This probe times it by ``chip_smoke.queued_ms`` (CUDA events
around calls queued behind a sleeping kernel), weights cold in L2, at:

* chatglm3-6b's 7 layer GEMMs at M 4 and 512, bf16 (phase 3's tile column);
* one fp32 training GEMM, [2048 x 4096] @ [4096 x 4096] (10(a)'s ``wo dA``);
* deepseek-moe-16b's w_up expert GEMM (G 64, 2048 -> 1408) at M 1, bf16
  (phase 5's tile column);
* each of those in the dtypes this checkout's kernels take beyond the one
  it was written for, where it takes them (e4m3 weights, fp16 @ bf16);
* K3's tile route at phase 9's causal prefill (B 4, H 32, S = T = 2048,
  D 128) and decode row (S 1), bf16, and at the prefill in fp32 with D 64;
  where the checkout's K3 takes them, at the prefill with D 80 in fp16 and
  in e4m3 (the general instantiation).

Needs a CUDA device. Run from the root of a checkout, with the checkout to
time first on the path and its own build directory::

    REPRO_TORCH_BUILD_DIR=build/probe_a PYTHONPATH=/path/to/a/src python tools/tile_route_probe.py
    REPRO_TORCH_BUILD_DIR=build/probe_b PYTHONPATH=src python tools/tile_route_probe.py

It prints one JSON line a case and a last line with the package's path.
Alternate the two checkouts in one call (a, b, b, a) to compare them.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_route_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import importlib

    import chip_smoke as cs
    import repro_torch

    k1 = importlib.import_module("repro_torch.kernels.opope_gemm")
    k4 = importlib.import_module("repro_torch.kernels.opope_grouped")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    pairs = [(bf16, bf16), (f32, f32)]
    try:  # a checkout whose kernels take the 8-bit floats and mixed pairs
        k1.compute_dtype(torch.float8_e4m3fn, bf16)
        pairs += [(torch.float8_e4m3fn, torch.float8_e4m3fn), (torch.float16, bf16)]
    except AttributeError:
        pass

    def case(name, a, bs, run):
        n_bufs = len(bs)
        ms = cs.queued_ms(torch, lambda i: run(a, bs[i % n_bufs]), max(20, n_bufs))
        print(json.dumps({"case": name, "a": str(a.dtype), "b": str(bs[0].dtype), "ms": ms}),
              flush=True)
        return ms

    def weights(shape, dtype, k):
        n_bufs = max(1, min(64, math.ceil(3 * cs.L2_BYTES / (math.prod(shape) * 2))))
        return [(torch.randn(shape, generator=gen, device=dev) * k ** -0.5).to(dtype)
                for _ in range(n_bufs)]

    tile = lambda a, b: k1._run(a, b, None, None, (), (), route="tile")  # noqa: E731
    d, dq, dkv, dff = 4096, 4096, 256, 13696
    layer = [(d, dq), (d, dkv), (d, dkv), (dq, d), (d, dff), (d, dff), (dff, d)]
    for adt, bdt in pairs:
        for m in (4, 512):
            total = 0.0
            for kk, n in layer:
                a = torch.randn((m, kk), generator=gen, device=dev).to(adt)
                total += case(f"K1 {kk}->{n} M={m}", a, weights((kk, n), bdt, kk), tile)
            print(json.dumps({"case": f"K1 chatglm3-6b layer M={m}", "a": str(adt),
                              "b": str(bdt), "ms": total}), flush=True)
        a = torch.randn((64, 1, 2048), generator=gen, device=dev).to(adt)
        case("K4 w_up G=64 M=1", a, weights((64, 2048, 1408), bdt, 2048),
             lambda x, y: k4._run(x, y, None, None, (), (), route="tile"))
    k3 = importlib.import_module("repro_torch.kernels.opope_attention")
    k3_cases = [(2048, 128, bf16), (1, 128, bf16), (2048, 64, f32)]
    if hasattr(k3, "_tile_vector"):  # a checkout whose K3 takes any head dim and dtype
        k3_cases += [(2048, 80, torch.float16), (2048, 80, torch.float8_e4m3fn)]
    for s_, d_, dt in k3_cases:
        q = torch.randn((4, 32, s_, d_), generator=gen, device=dev).to(dt)
        kv = torch.randn((4, 32, 2048, d_), generator=gen, device=dev).to(dt)
        case(f"K3 B=4 H=32 S={s_} T=2048 D={d_} causal", q, [kv],
             lambda x, y: k3._launch(x, y, y, True, 128, 128, route="tile"))
    a = torch.randn((2048, 4096), generator=gen, device=dev)
    case("K1 fp32 [2048x4096]@[4096x4096]", a, weights((4096, 4096), f32, 4096),
         lambda x, y: k1._run(x, y, None, f32, (), (), route="tile"))
    print(json.dumps({"package": str(Path(repro_torch.__file__).resolve().parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
