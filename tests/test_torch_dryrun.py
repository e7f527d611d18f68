"""The dry run (``launch/dryrun.py``, ``launch/cost.py``,
``launch/roofline.py``) on the CPU.

* **Counts are the device's.**  ``launch/cost.py`` over a real CPU step of
  a reduced config (seeded state, a real batch) counts the FLOPs, HBM
  bytes, launches and peak live bytes that the same step counts on the
  meta device: with every wrapper on its plain version, and on its
  kernel's route (on the CPU the launch functions are made to skip their
  CUDA call, as the meta route does), which is what the card runs.
* **Dry collectives are real ones.**  The dry meshes (1, 2), (2, 2) and
  (2, 1, 2) count, by kind and tag, what gloo ranks count running the same
  train, prefill and decode steps on the same batch (every gloo rank
  counts the same; the dry run's first and last rank are held to them).
* ``model_flops`` equals ``repro.launch.roofline.model_flops`` for every
  assigned arch × shape.
* For every assigned arch at 16×16 and 2×16×16, each state leaf a rank
  holds has the shard shape of the reference's ``state_specs`` on that
  mesh, or where ROADMAP queue C documents a difference, the documented
  rule: a dim the mesh does not divide stays whole (GSPMD pads), a dim
  the model's layers do not cut stays whole over ``model``, the fused SSM
  leaves are cut by segments, and V1 is whole over ``data``.
* One full-width cell, qwen3-0.6b ``decode_32k`` on 2×16×16, runs end to
  end on meta and writes the reference's file name.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost import CostMode  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.launch.mesh import dry_mesh  # noqa: E402
from repro_torch.launch.roofline import model_flops  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.launch.state import init_state, state_structs  # noqa: E402
from repro_torch.launch.steps import make_train_step, mesh_layout, model_cuts  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import ssm_segments, tree_leaves  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from tests.test_torch_dist import TINY  # noqa: E402

KERNEL_MODULES = ("rmsnorm", "flash_attention", "swiglu", "lowrank_wgrad", "flash_decode",
                  "paged_decode", "paged_decode_q8")
FLAGS = ExecFlags(remat="ffn", ce_chunk=16)
MECEFO = tbase.MeCeFOConfig(mode="dynamic", rank=8)
TRAIN = tbase.TrainConfig()
B, S = 4, 32


def kernel_route(monkeypatch):
    """Every wrapper takes its kernel's route on the CPU, its launch
    function making the outputs and calling nothing (the meta route)."""
    import importlib

    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        monkeypatch.setattr(mod, "runs_plain", lambda *t: kernels._PLAIN)
        if hasattr(mod, "on_meta"):
            monkeypatch.setattr(mod, "on_meta", lambda t: True)


def reduced(name, **kw):
    cfg = tbase.reduced(tbase.get_config(name), dtype="float32", **kw)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def counted(cost):
    return (cost.flops, cost.bytes, cost.launches, cost.peak_bytes, cost.start_bytes,
            cost.kernel_work, cost.n_ops)


def real_train_cost(cfg, mode):
    """The counts of one real CPU train step: seeded state, a real batch."""
    shape = tbase.ShapeConfig("t", S, B, "train")
    state = init_state(cfg, TRAIN, MECEFO, torch.Generator().manual_seed(0), device="cpu")
    shapes, _ = input_specs(cfg, shape, ShardingRules(), {})
    batch = {k: torch.tensor(np.asarray(v), dtype=shapes[k][1])  # a storage of its own each
             for k, v in SyntheticLM(cfg.vocab_size).batch(0, B, S).items()}
    step = make_train_step(cfg, TRAIN, MECEFO, shape, ndb_mode=mode, flags=FLAGS, device="cpu")
    args = [state, batch]
    if mode == "dynamic":
        args.append({"keep": torch.ones(cfg.n_layers, B), "example_weight": torch.ones(B)})
    with CostMode(args) as m:
        step(*args)
    return m.cost


@pytest.mark.parametrize("name,mode,route", [
    ("llama-350m", "off", "plain"), ("qwen3-moe-30b-a3b", "degraded", "plain"),
    ("llama-350m", "off", "kernel"), ("llama-350m", "degraded", "kernel"),
    ("llama-350m", "dynamic", "kernel"), ("qwen3-moe-30b-a3b", "degraded", "kernel"),
    ("mamba2-2.7b", "degraded", "kernel")])
def test_cost_of_a_real_cpu_step_equals_the_meta_dry_run(name, mode, route, monkeypatch):
    cfg = reduced(name)
    if route == "kernel":
        kernel_route(monkeypatch)
    with (kernels.plain_versions() if route == "plain" else _nothing()):
        real = real_train_cost(cfg, mode)
        dry = dryrun.dry_step(cfg, tbase.ShapeConfig("t", S, B, "train"), None, ndb=mode,
                              mecefo=MECEFO, train=TRAIN, flags=FLAGS)
    assert counted(real) == counted(dry.cost)
    assert real.flops > 0 and real.peak_bytes > real.start_bytes
    if route == "kernel":
        want = {"rmsnorm", "swiglu", "swiglu_bwd"}
        if cfg.family != "ssm":
            want.add("flash_attention")
        if mode == "degraded" and cfg.moe is None:  # the dense FFN's low-rank Wgrad
            want.add("lowrank_wgrad")
        assert want <= set(real.launches)
    else:
        assert real.launches == {}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["llama-350m", "qwen3-moe-30b-a3b", "mamba2-2.7b"])
def test_serve_step_counts_on_the_cpu_equal_meta(name, kind, monkeypatch):
    cfg = reduced(name)
    kernel_route(monkeypatch)
    shape = tbase.ShapeConfig(kind, S, B, kind)
    cpu = dryrun.dry_step(cfg, shape, None, device="cpu")
    meta = dryrun.dry_step(cfg, shape, None)
    assert counted(cpu.cost) == counted(meta.cost) and cpu.state_bytes == meta.state_bytes
    if kind == "decode" and cfg.family != "ssm":  # every lane over its S rows
        w = meta.cost.kernel_work["flash_decode"]
        hd = cfg.resolved_head_dim
        assert w["flops"] == 4.0 * cfg.n_heads * hd * B * S * cfg.n_layers


# ---------------------------------------------------------------------------
# dry collectives against gloo ranks
# ---------------------------------------------------------------------------

# tests/test_torch_dist.py's tiny configs at a head width the kernels take
MESH_CFGS = {"dense": dict(TINY["dense"], d_model=128), "moe": dict(TINY["moe"], d_model=128)}
MESH_SHAPES = [tbase.ShapeConfig("t", S, 8, "train"), tbase.ShapeConfig("p", 16, 4, "prefill"),
               tbase.ShapeConfig("d", 24, 4, "decode")]
MESH_CASES = [("dense", "tp_fsdp", "dynamic"), ("moe", "fsdp", "degraded")]


def mesh_cfg(name):
    fields = dict(MESH_CFGS[name])
    if "moe" in fields:
        fields["moe"] = tbase.MoEConfig(**fields["moe"])
    return tbase.ModelConfig(**fields)


def mesh_counts(mesh):
    """Every case's collectives by kind and tag on this mesh's rank."""
    from repro_torch.parallel import collectives

    out = {}
    for name, smode, mode in MESH_CASES:
        for shape in MESH_SHAPES:
            collectives.reset_counts()
            dryrun.dry_step(mesh_cfg(name), shape, mesh, ndb=mode, mecefo=MECEFO,
                            parallel=tbase.ParallelConfig(sharding_mode=smode), flags=FLAGS)
            out[(name, smode, mode, shape.kind)] = collectives.counts()
    return out


def gloo_rank(mesh, out_dir, shapes):
    """Each mesh of ``shapes`` over this process group (the spawn's own
    first): its cases' counts."""
    from repro_torch.launch.mesh import make_host_mesh

    for P, D, M in shapes:
        m = mesh if (P, D, M) == shapes[0] else make_host_mesh(D, M, device="cpu", pod=P)
        torch.save(mesh_counts(m), os.path.join(out_dir, f"counts.{P}.{D}.{M}.{m.rank}.pt"))


# one spawn a world size: (1, 2) on 2 ranks, (2, 2) and (2, 1, 2) on 4
@pytest.mark.parametrize("shapes", [[(None, 1, 2)], [(None, 2, 2), (2, 1, 2)]])
def test_dry_collectives_equal_gloo_ranks(shapes, tmp_path):
    P, D, M = shapes[0]
    W = (P or 1) * D * M
    spawn(gloo_rank, W, str(tmp_path), shapes, model=M, pod=P, device="cpu", timeout=300)
    for P, D, M in shapes:
        real = [torch.load(tmp_path / f"counts.{P}.{D}.{M}.{r}.pt") for r in range(W)]
        assert all(x == real[0] for x in real), (P, D, M)  # every rank counts the same
        for r in (0, W - 1):  # the first and the last rank, dry
            dry = mesh_counts(dry_mesh(P, D, M, rank=r))
            assert dry == real[r], (P, D, M, r)
        for key, c in dry.items():  # the train steps reduce their gradients
            if key[-1] == "train":
                assert any(t.startswith("grad:") for k in c for t in c[k]), key


# ---------------------------------------------------------------------------
# model_flops and the reference's shard shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_model_flops_equals_the_reference(arch):
    from repro.configs import base as jbase
    from repro.launch.roofline import model_flops as jflops

    for name, shape in tbase.SHAPES.items():
        assert model_flops(tbase.get_config(arch), shape) == \
            jflops(jbase.get_config(arch), jbase.SHAPES[name]), (arch, name)


def _stand_in(shape: dict):
    from types import SimpleNamespace

    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape),
                           devices=np.empty(tuple(shape.values())))


def _specs(tree) -> list:
    from jax.sharding import PartitionSpec

    import jax

    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, PartitionSpec))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _check_dim(what, size, local, ref_axes, port_axes, sizes, logical, cuts, v1=False):
    """One dim of a leaf a rank holds against the reference's spec entry:
    the reference's shard, or a documented difference (module docstring)."""
    n_ref = math.prod(sizes[a] for a in ref_axes)
    assert set(port_axes) <= set(ref_axes), (what, port_axes, ref_axes)
    assert local == size // math.prod(sizes[a] for a in port_axes), (what, local, port_axes)
    for a in set(ref_axes) - set(port_axes):
        padded = size % n_ref != 0  # GSPMD pads; the port keeps the dim whole
        uncut = a == "model" and logical not in cuts  # the layers do not cut it
        assert padded or uncut or (v1 and a == "data"), (what, a, size, ref_axes)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", dryrun.ASSIGNED)
def test_state_shards_equal_the_reference_specs(arch, multi):
    from repro.configs import base as jbase
    from repro.launch.state import state_specs as jstate_specs
    from repro.launch.steps import build_rules as jbuild_rules
    from repro_torch.core.lowrank import init_projections, projection_annotations
    from repro_torch.launch.state import _ann_leaves, param_structs

    sizes = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    cfg = tbase.get_config(arch)
    mecefo = tbase.MeCeFOConfig(mode="dynamic")
    mesh = dry_mesh(sizes.get("pod"), 16, 16)
    layout = mesh_layout(cfg, mesh, tbase.ParallelConfig())
    cuts = model_cuts(cfg, mesh, tbase.ParallelConfig())
    got = state_structs(cfg, TRAIN, mecefo, layout)
    jcfg = jbase.get_config(arch)
    rules = jbuild_rules(jcfg, _stand_in(sizes), jbase.ParallelConfig())
    want = jstate_specs(jcfg, jbase.TrainConfig(), jbase.MeCeFOConfig(mode="dynamic"), rules)
    segs = ssm_segments(cfg) if cfg.ssm is not None else {}
    from repro_torch.models.params import param_annotations

    anns = _ann_leaves(param_annotations(cfg))
    for part, mine, ref in (("params", got.params, want.params), ("m", got.opt.m, want.opt.m),
                            ("v", got.opt.v, want.opt.v)):
        xs, specs = tree_leaves(mine), _specs(ref)
        assert len(xs) == len(specs) == len(layout.paths), part
        for k, (x, spec) in enumerate(zip(xs, specs)):
            path = layout.paths[k]
            name = path.rsplit(".", 1)[-1]
            for dim in range(x.dim()):
                ref_axes = _axes(spec[dim]) if dim < len(spec) else ()
                port = ("model",) if layout.mdims[k] == dim else ()
                if layout.dims[k] == dim:
                    port += layout.groups[k]
                size, what = layout.shapes[k][dim], (part, path, dim)
                if port == ("model",) and name in segs and ".mixer." in path:
                    assert x.shape[dim] == sum(w // 16 if cut else w for w, cut in segs[name])
                    assert "model" in ref_axes, what
                    continue
                _check_dim(what, size, x.shape[dim], ref_axes, port, sizes, anns[k][dim], cuts)
    pw = tree_leaves(init_projections(param_structs(cfg), cfg, mecefo.rank))
    panns = _ann_leaves(projection_annotations(cfg))
    xs, specs = tree_leaves(got.proj), _specs(want.proj)
    assert len(xs) == len(specs) == len(pw) == len(panns)
    for k, (x, spec, w) in enumerate(zip(xs, specs, pw)):
        for dim in range(x.dim()):
            ref_axes = _axes(spec[dim]) if dim < len(spec) else ()
            port = ("model",) if layout.proj_mdims and layout.proj_mdims[k] == dim else ()
            _check_dim(("proj", k, dim), w.shape[dim], x.shape[dim], ref_axes, port, sizes,
                       panns[k][dim], cuts, v1=True)


# ---------------------------------------------------------------------------
# one full-width cell end to end
# ---------------------------------------------------------------------------


def test_full_width_decode_cell_runs_on_meta(tmp_path):
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", True, out_dir=str(tmp_path),
                          verbose=False)
    path = tmp_path / "qwen3-0.6b__decode_32k__multi.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    cfg = tbase.get_config("qwen3-0.6b")
    assert rec["n_devices"] == 512 and rec["mesh"] == "multi" and rec["fits"]
    assert rec["launches"]["flash_decode"] == cfg.n_layers
    assert rec["launches"]["rmsnorm"] > 0 and rec["launches"]["swiglu"] == cfg.n_layers
    assert 0 < rec["state_bytes_per_dev"] <= rec["peak_bytes_per_dev"] < 80 * 2 ** 30
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck", "useful_flops_ratio",
                "roofline_fraction", "seconds"):
        assert key in rec, key
    # B 128 over (pod, data): 4 rows a rank, each over a full 32k cache
    hd = cfg.resolved_head_dim
    assert rec["kernel_work"]["flash_decode"]["flops"] == \
        4.0 * (cfg.n_heads // 16) * hd * 4 * 32768 * cfg.n_layers
    skip = dryrun.run_cell("qwen3-0.6b", "long_500k", True, out_dir=str(tmp_path),
                           verbose=False)
    assert "skipped" in skip and (tmp_path / "qwen3-0.6b__long_500k__multi.json").exists()
    with pytest.raises(NotImplementedError):
        dryrun.run_cell("qwen3-0.6b", "decode_32k", True, out_dir=str(tmp_path), pallas=True)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
