"""Boundaries of the PyTorch/CUDA port.

* No file of the port (``src/repro_torch``) nor ``chip_smoke.py`` nor a
  tool of the port (``tools/``) imports JAX or the JAX package ``repro``:
  the port keeps its own copies.
* Entry points default to ``cuda`` and, without a CUDA device, raise
  instead of running on the CPU.
* ``chip_smoke.py`` fails without a CUDA device and outside a checkout,
  printing no result.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build as kbuild
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.models.transformer import param_dtype

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
TOOL_FILES = sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES + TOOL_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_is_scanned():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES[:-1]}
    for mod in ("repro_torch/kernels/opope_gemm.py", "repro_torch/kernels/opope_grouped.py",
                "repro_torch/models/moe.py", "repro_torch/serve/continuous.py",
                "repro_torch/models/api.py", "repro_torch/configs/base.py",
                "repro_torch/quant/quantize.py", "repro_torch/quant/policy.py",
                "repro_torch/quant/opope_q8.py", "repro_torch/quant/backends.py",
                "repro_torch/kernels/ref.py", "repro_torch/kernels/opope_attention.py",
                "repro_torch/kernels/opope_scan.py", "repro_torch/kernels/__init__.py",
                "repro_torch/obs/metrics.py", "repro_torch/obs/spans.py",
                "repro_torch/obs/logging.py", "repro_torch/obs/tracing.py",
                "repro_torch/obs/attr.py", "repro_torch/obs/audit.py",
                "repro_torch/obs/http.py", "repro_torch/core/roofline.py",
                "repro_torch/launch/stats.py", "repro_torch/checkpoint/__init__.py",
                "repro_torch/checkpoint/checkpoint.py"):
        assert mod in names
    assert kbuild.sources() == ["opope_attention", "opope_gemm", "opope_grouped", "opope_q8",
                                "opope_q8_grouped", "opope_scan"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    cfg = get_config("chatglm3-6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_state(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "chatglm3-6b", "--reduced"])
    # Asking for the CPU explicitly works.
    params = api.init_params(cfg, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"


def test_launch_serve_runs_on_the_cpu_when_asked(capsys):
    out = launch_serve.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
                             "--n-requests", "3", "--gen", "4", "--prompt-len", "8"])
    assert out["device"] == "cpu" and out["requests"] == 3
    assert out["tokens"] > 0 and out["decode_steps"] > 0
    assert '"engine": "continuous"' in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_launch_serve_runs_the_recurrent_families_on_both_engines(arch, engine):
    """No fallback for a token-prompt model with recurrent mixers: the
    engine asked for serves it."""
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--engine", engine,
                             "--n-requests", "2", "--batch", "2", "--gen", "3",
                             "--prompt-len", "6"])
    assert out["engine"] == engine
    vocab = get_config(arch).reduced().vocab
    toks = out["first_request_output"] if engine == "continuous" else out["first_sequence"]
    assert len(toks) > 0 and all(0 <= t < vocab for t in toks)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base"])
def test_launch_serve_falls_back_to_static_with_the_non_token_input(arch, monkeypatch, capsys):
    # Asked for the default (continuous) engine, a vlm or audio model is
    # served by the static one; its prefill gets the input_specs layout in
    # the parameters' dtype and a cache that holds the image rows too.
    cfg = get_config(arch).reduced()
    seen = []
    real_prefill = api.prefill

    def prefill(cfg_, params, batch, max_len, *a, **k):
        seen.append((dict(batch), max_len))
        return real_prefill(cfg_, params, batch, max_len, *a, **k)

    monkeypatch.setattr(api, "prefill", prefill)
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                             "--gen", "4", "--prompt-len", "8"])
    assert f"[serve] engine_fallback family={cfg.family} engine=static" in capsys.readouterr().out
    assert out["engine"] == "static" and out["shape"] == [2, 4]
    assert all(0 <= t < cfg.vocab for t in out["first_sequence"])
    (batch, max_len), = seen
    assert max_len == cfg.n_img_tokens + 8 + 4
    specs = api.input_specs(cfg, batch=2, seq=cfg.n_img_tokens + 8, kind="prefill")
    assert sorted(batch) == sorted(specs)
    for key, spec in specs.items():
        assert batch[key].shape == spec.shape and batch[key].device.type == "cpu"
        want = param_dtype(cfg) if spec.is_floating_point() else batch["tokens"].dtype
        assert batch[key].dtype == want, key
    assert param_dtype(cfg) != torch.bfloat16  # so the draw did not follow input_specs' bf16


def test_kernel_build_dir_lies_in_the_checkout_or_is_named(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert kbuild.build_dir() == ROOT / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert kbuild.build_dir() == tmp_path


def test_kernel_build_dir_outside_a_checkout_raises(monkeypatch, tmp_path):
    # An installed copy: site-packages/repro_torch/kernels/build.py.
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setattr(kbuild, "__file__",
                        str(tmp_path / "site-packages" / "repro_torch" / "kernels" / "build.py"))
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        kbuild.build_dir()


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # Alone in a directory, without the package, it fails too.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
