"""Fixtures of the harness's tests: a temporary copy of ``bench/`` with
tiny cells (f32, 2 layers, d 128, S 32, rank 8) beside the real ones, and
the look for a card.

    python -m pytest -q bench/tests

The tests run on the CPU; those marked ``cuda`` run the tiny cells on a
card and skip without one.
"""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {
    "source": "tiny", "program_config": "bench-tiny-glm4", "num_layers": 1, "hidden_size": 128,
    "ffn_hidden_size": 192, "num_attention_heads": 4, "multi_query_group_num": 2,
    "kv_channels": 32, "padded_vocab_size": 512, "torch_dtype": "float32",
    "port": {"qk_norm": False, "norm_eps": 1e-5, "rope_theta": 10000.0}}
TINY_MOE = {
    "source": "tiny", "program_config": "bench-tiny-qwen3-moe", "num_hidden_layers": 1,
    "hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "vocab_size": 512, "num_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 48,
    "rope_theta": 1e6, "rms_norm_eps": 1e-5, "router_aux_loss_coef": 0.01,
    "torch_dtype": "float32", "port": {"qk_norm": True, "capacity_factor": 1.25}}
TINY_CELLS = [f"{c}.{t}" for c in ("tiny-dense", "tiny-moe") for t in ("neighbor", "healthy")]
# the tiny cells' limits: in f32 the program and the reference agree to
# ~1e-6 (loss, grad), ~1e-5 (grad_leaf, change); a fault reads 1e-2 or more
TINY_LIMITS = {"loss": 1e-4, "grad": 1e-4, "grad_leaf": 1e-3, "change": 1e-3}


def _register_tiny():
    """The tiny configurations in the program's registry, as the program's
    own glm4-9b and qwen3-moe at the tiny widths (and, for the FLOP count,
    the MoE one at capacity factor 1)."""
    import dataclasses

    from repro_torch.configs.base import get_config, register

    rep = dataclasses.replace
    small = dict(d_model=128, n_heads=4, n_kv_heads=2, vocab_size=512, dtype="float32")
    register(rep(get_config("glm4-9b"), name="bench-tiny-glm4", d_ff=192, **small))
    q = get_config("qwen3-moe-30b-a3b")
    moe = rep(q.moe, n_experts=8, top_k=2, d_ff_expert=48)
    register(rep(q, name="bench-tiny-qwen3-moe", head_dim=32, moe=moe, **small))
    register(rep(q, name="bench-tiny-qwen3-moe-cf1", head_dim=32,
                 moe=rep(moe, capacity_factor=1.0), **small))


_register_tiny()


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def make_root(tmp) -> str:
    """A checkout-like root in ``tmp``: ``bench/`` copied, the tiny
    configurations, traffic cut to S 32 and rank 8, a ``BENCHMARK.json`` of
    the tiny cells with the real metrics."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(BENCH, os.path.join(root, "bench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = os.path.join(root, "bench")
    write_json(os.path.join(b, "configs", "tiny-dense.json"), TINY_DENSE)
    write_json(os.path.join(b, "configs", "tiny-moe.json"), TINY_MOE)
    for t in ("neighbor", "healthy"):
        tr = read_json(os.path.join(b, "traffic", f"{t}.json"))
        tr["seq_len"], tr["mecefo"]["rank"] = 32, 8
        write_json(os.path.join(b, "traffic", f"{t}.json"), tr)
    for c in TINY_CELLS:
        write_json(os.path.join(b, "limits", f"{c}.json"), TINY_LIMITS)
    real = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    bm = dict(real, configs=[
        {"name": n, "source": "tiny", "file": f"bench/configs/{n}.json", "reduced": [],
         "why": "tiny"} for n in ("tiny-dense", "tiny-moe")],
        workloads=[{"name": c, "config": c.split(".")[0], "traffic": c.split(".")[1],
                    "chips": 1, "why": "tiny"} for c in TINY_CELLS])
    bm["per_layer"] = [dict(e, workloads=TINY_CELLS) for e in real["per_layer"]]
    write_json(os.path.join(root, "BENCHMARK.json"), bm)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def run_tiny(root, name, *, trace=False, device="cpu", program=None, seed=2 ** 33 + 11,
             calibrate=False):
    import time

    import run
    import spec

    cell = spec.load_cell(root, name, os.path.join(root, "bench"), calibrate=calibrate)
    return run.run_cell(cell, seed, 0.2, trace, device, root=root,
                        bench_dir=os.path.join(root, "bench"), program=program,
                        t_start=time.perf_counter())
