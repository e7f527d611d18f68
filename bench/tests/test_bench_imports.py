"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: module names compared by their
top-level part (before the first dot) as a whole, so ``repro_torch`` is
not ``repro``."""
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import glob, os, sys
sys.path[:0] = [{src!r}, {bench!r}]
import run, spec, check, weights, traffic, devtrace, program, control
import reference.model, flops.healthy, flops.degraded, roofline.flash_attention
import roofline.lowrank_wgrad, roofline.swiglu
for p in sorted(glob.glob(os.path.join({bench!r}, "metrics", "*.py"))):
    run.reader(os.path.basename(p)[:-3])
import program as P
P.program_config(spec.load_cell({root!r}, "glm4-9b-pp8.neighbor"))
from repro_torch.launch.steps import make_train_step
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys
sys.path[:0] = [{bench!r}]
import reference.model
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(src=os.path.join(ROOT, "src"),
                                                            bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    mods = _top_level(HARNESS)
    assert "repro_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE)
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and bench/ fails, and says
    nothing on standard output."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "glm4-9b-pp8.neighbor",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    # what it imported is compiled into the checkout's byte-code cache
    assert any((tmp_path / ".bench_cache" / "pycache").rglob("*.pyc"))


@pytest.mark.parametrize("mod", sorted(FORBIDDEN))
def test_the_forbidden_names_are_whole_top_level_names(mod):
    assert "repro_torch".split(".")[0] != mod
