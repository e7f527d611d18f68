"""The port's sharding rules, specs and annotations
(``repro_torch.parallel.sharding``, ``launch/specs.py``,
``launch/state.py:state_specs``, ``models/params.py:param_annotations``,
``core/lowrank.py:projection_annotations``) against the live JAX functions.

A JAX ``PartitionSpec`` and the port's ``Spec`` compare as tuples of their
entries.  ``default_rules`` reads a mesh's axis names and sizes only, so
the JAX side takes a mesh-shaped stand-in for the 2×1 and 4×1 meshes the
one CPU device cannot build.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import projection_annotations as jax_proj_ann  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.state import state_specs as jax_state_specs  # noqa: E402
from repro.models.params import param_annotations as jax_param_ann  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.lowrank import projection_annotations  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.state import state_specs  # noqa: E402
from repro_torch.models.params import param_annotations  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

NAMES = ("batch", "seq", "embed", "embed_tbl", "heads", "kv_heads", "mlp", "vocab",
         "expert", "expert_embed", "ssm_inner", "norm", "stacked", None)


def _stand_in(data, model=1):
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": data, "model": model})


def _as_tuple(tree, is_leaf):
    return jax.tree.map(tuple, tree, is_leaf=is_leaf)


def _configs():
    jbase.get_config("llama-350m")  # fills the registry
    return sorted(jbase._REGISTRY)


@pytest.mark.parametrize("fields", [{}, {"seq": "model"}, {"embed": ("data", "model")},
                                    {"batch": ("data",), "mlp": None}])
def test_rules_spec_matches_jax(fields):
    jr, tr = jsh.ShardingRules(**fields), tsh.ShardingRules(**fields)
    for logical in itertools.product(NAMES, repeat=3):
        assert tuple(tr.spec(*logical)) == tuple(jr.spec(*logical)), logical
        assert tuple(tsh.logical_to_spec(tr, logical)) == tuple(jsh.logical_to_spec(jr, logical))
    # the dedupe case of tests/test_launch.py: seq and mlp both want 'model'
    r = dataclasses.replace(tsh.ShardingRules(), seq="model")
    assert r.spec("batch", "seq", "mlp") == tsh.Spec(("pod", "data"), "model", None)
    assert tuple(tsh.batch_spec(tr)) == tuple(jsh.batch_spec(jr))


@pytest.mark.parametrize("data", [1, 2, 4])
def test_default_rules_match_jax(data):
    for fsdp, sp, kv in itertools.product((True, False), (True, False), (0, 1, 2, 3, 8)):
        kw = dict(fsdp=fsdp, sequence_parallel=sp, n_kv_heads=kv)
        want = jsh.default_rules(_stand_in(data), **kw)
        assert dataclasses.asdict(tsh.default_rules(_stand_in(data), **kw)) == \
            dataclasses.asdict(want), kw
    if data == 1:  # the port's own 1×1 mesh of one process
        got = tsh.default_rules(make_host_mesh(device="cpu"), fsdp=True)
        assert got == tsh.ShardingRules(**dataclasses.asdict(
            jsh.default_rules(_stand_in(1), fsdp=True)))


def test_batch_axes_for_matches_jax():
    for data, fsdp in itertools.product((1, 2, 4), (True, False)):
        jr = jsh.default_rules(_stand_in(data), fsdp=fsdp)
        tr = tsh.default_rules(_stand_in(data), fsdp=fsdp)
        for B in (1, 2, 3, 4, 6, 8, 9, 16):
            msd = {"data": data, "model": 1}
            assert tspecs.batch_axes_for(B, tr, msd) == jspecs.batch_axes_for(B, jr, msd), (data, B)


@pytest.mark.parametrize("name", _configs())
def test_param_and_projection_annotations_match_jax(name):
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    assert param_annotations(tcfg) == jax_param_ann(jcfg)
    assert projection_annotations(tcfg) == jax_proj_ann(jcfg)


@pytest.mark.parametrize("name", ["llama-350m", "qwen3-moe-30b-a3b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_state_and_input_specs_match_jax(name, data):
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    for fsdp, mode, opt in itertools.product((True, False), ("off", "dynamic"), ("adamw", "sgdm")):
        jr = jsh.default_rules(_stand_in(data), fsdp=fsdp)
        tr = tsh.default_rules(_stand_in(data), fsdp=fsdp)
        want = jax_state_specs(jcfg, jbase.TrainConfig(optimizer=opt),
                               jbase.MeCeFOConfig(mode=mode), jr)
        got = state_specs(tcfg, tbase.TrainConfig(optimizer=opt), tbase.MeCeFOConfig(mode=mode),
                          tr)
        is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
        assert tuple(got.step) == tuple(want.step)
        for part in ("params", "opt", "proj"):
            j = _as_tuple(getattr(want, part), is_p)
            t = tsh.map_tree(tuple, getattr(got, part), lambda s: isinstance(s, tsh.Spec))
            assert _flat(t) == _flat(j), (part, fsdp, mode, opt)
    shape = tbase.ShapeConfig("t", 64, 8, "train")
    msd = {"data": data, "model": 1}
    tr = tsh.default_rules(_stand_in(data))
    jr = jsh.default_rules(_stand_in(data))
    _, tspec = tspecs.input_specs(tcfg, shape, tr, msd)
    _, jspec = jspecs.input_specs(jcfg, jbase.ShapeConfig("t", 64, 8, "train"), jr, msd)
    assert {k: tuple(v) for k, v in tspec.items()} == {k: tuple(v) for k, v in jspec.items()}
    bax = tspecs.batch_axes_for(8, tr, msd)
    assert {k: tuple(v) for k, v in tspecs.ndb_specs(tcfg, 8, bax)[1].items()} == \
        {k: tuple(v) for k, v in jspecs.ndb_specs(jcfg, 8, bax)[1].items()}


def _flat(tree):
    """(path, entries) pairs of a tree of spec tuples."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(v, path + (k,))
        elif isinstance(x, tuple) and x and isinstance(x[0], dict):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out.append((path, tuple(x)))

    walk(tree, ())
    return out


def test_rows_of_and_constrain():
    mesh = make_host_mesh(device="cpu")
    assert tspecs.rows_of(8, ("data",), mesh) == slice(0, 8)
    assert tspecs.rows_of(9, None, mesh) == slice(0, 9)
    mesh2 = SimpleNamespace(shape={"data": 4, "model": 1}, rank=3)
    assert tspecs.rows_of(8, ("data",), mesh2) == slice(6, 8)
    x = torch.ones(2)
    assert tsh.constrain(x, tsh.ShardingRules(), "batch") is x
    assert tsh.is_annotation(("embed", None)) and not tsh.is_annotation(tsh.Spec("data"))
