"""The port's boundaries: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

IMPORT_CHECK = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
print(" ".join(sorted(n for n in sys.modules if n.startswith("repro_torch"))))
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.strip().splitlines()[-1].split())
    assert len(imported) >= 20  # every module was imported
    assert {"repro_torch.serve.replicas", "repro_torch.serve.trace",
            "repro_torch.kernels.kvquant", "repro_torch.kernels.paged_decode_q8"} <= imported


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_repro_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device would work")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.base import (
        MeCeFOConfig, ShapeConfig, TrainConfig, get_config, reduced,
    )
    from repro_torch.launch.state import init_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import init_params
    from repro_torch.serve import run
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = reduced(get_config("qwen3-0.6b"), dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.build("qwen3-0.6b", use_reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--requests", "1"])
    train, mecefo = TrainConfig(), MeCeFOConfig(mode="dynamic")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg, train, mecefo, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, train, mecefo, ShapeConfig("t", 8, 2, "train"))
    assert init_state(cfg, train, mecefo, torch.Generator(), device="cpu").step == 0
    make_train_step(cfg, train, mecefo, ShapeConfig("t", 8, 2, "train"), device="cpu")


def test_serve_run_cli_on_cpu(capsys):
    import json

    from repro_torch.serve import run

    assert run.main(["--device", "cpu", "--requests", "3", "--prompt-min", "4",
                     "--prompt-max", "12", "--gen-min", "2", "--gen-max", "5", "--slots", "2",
                     "--page-size", "4", "--pages-per-slot", "5", "--chaos", "none"]) == 0
    out = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")))
    assert out["n_completed"] == 3 and out["device"] == "cpu"
    assert out["dtype"] == "float32" and out["n_layers"] == 2  # the reduced config
    assert out["decode_rounds"] > 0 and out["n_admission_plans"] > 0


def test_chip_smoke_refuses_without_cuda(no_cuda):
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
