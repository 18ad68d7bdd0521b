"""Whether K3's 8-bit gate catches a kernel that rounds P wrongly.

``chip_smoke.attn_check_fp8`` (and ``tests/test_torch_gpu.py``'s
``_attn_close_any``) hold K3 with e4m3 or e5m2 q, k and v against its plain
version: each element within one ulp plus one at the largest magnitude, and
the error's RMS within ``ATTN_FP8_RMS`` of the format's relative spacing.
This probe builds ``csrc/opope_attention.cu`` three ways from this
checkout, the mutants as copies in a directory of the build directory:

* ``kernel``: as it is;
* ``no_p_cast``: P not rounded to v's format before P·V (the lines of
  ``pack_p`` that call ``round_fp8`` removed), fp16 P as for fp16 v;
* ``own_panels``: P rounded at the running maximum through each of the
  kernel's own 64-key panels, not the reference's (the two-pass walk
  turned off).

and runs each on 17(c)'s K3 calls (B 4, H 16, S = T = 2048, causal, D 80,
256 and 320, e4m3) and at D 80 in e5m2, against the plain version. It
prints, per call and build, the RMS in spacings, the share of elements
that differ from the plain version's, the elements beyond the per-element
gate and whether the gate passes; it exits 1 unless every ``kernel`` call
passes and every mutant call fails.

Needs a CUDA device and nvcc. Run from the root of a checkout::

    python tools/fp8_attention_control_probe.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (name, the text the mutant removes or replaces, its replacement)
MUTANTS = (
    ("no_p_cast", "      lo = round_fp8(lo, vdt);\n      hi = round_fp8(hi, vdt);\n", ""),
    ("own_panels", "p.ref_bk == BKV || (p.ref_bk == p.t && p.t <= BKV)", "true"),
)


def build_mutant(kbuild, name, old, new):
    """Start nvcc on ``opope_attention.cu`` with ``old`` replaced by
    ``new``, a copy of the sources in ``<build dir>/control_<name>/``;
    returns the process and the library's path."""
    work = kbuild.build_dir() / f"control_{name}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kbuild.CSRC_DIR, work / "csrc")
    src = work / "csrc" / "opope_attention.cu"
    text = src.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"mutant {name}: the text to replace is not in the source once")
    src.write_text(text.replace(old, new))
    lib = work / "libopope_attention.so"
    return subprocess.Popen([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT), lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fp8_attention_control_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import importlib

    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild

    k3 = importlib.import_module("repro_torch.kernels.opope_attention")
    jobs = [(name, *build_mutant(kbuild, name, old, new)) for name, old, new in MUTANTS]
    libs = {"kernel": kbuild.load("opope_attention")}
    for name, proc, lib in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on mutant {name}")
        libs[name] = ctypes.CDLL(str(lib))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, s = cs.K3_DTYPE_SHAPE
    cases = [(torch.float8_e4m3fn, d) for d in cs.K3_DTYPE_DIMS] + [(torch.float8_e5m2, 80)]
    ok = True
    for dt, d in cases:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dt) for _ in range(3))
        want = k3.opope_attention_plain(q, k, v)
        w = want.float()
        spacing = 2.0 ** -3 if dt == torch.float8_e4m3fn else 2.0 ** -2
        for name, lib in libs.items():
            kbuild._LOADED["opope_attention"] = lib
            got = k3.opope_attention_bhsd(q, k, v)
            torch.cuda.synchronize()
            g = got.float()
            diff = (g - w).abs()
            tol = cs.ulp(torch, w, dt) + cs.ulp(torch, w.abs().max(), dt)
            rms = (diff.square().mean().sqrt() / w.square().mean().sqrt()).item()
            try:
                cs.attn_check_fp8(torch, got, want, name)
                passed = True
            except AssertionError:
                passed = False
            ok &= passed == (name == "kernel")
            print(json.dumps({"dtype": str(dt).removeprefix("torch."), "d": d, "build": name,
                              "rms_spacings": rms / spacing,
                              "share_differing": (g != w).float().mean().item(),
                              "beyond_element_gate": int((diff > tol).sum().item()),
                              "gate_passes": passed}), flush=True)
        kbuild._LOADED["opope_attention"] = libs["kernel"]
        del q, k, v, want, w
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
