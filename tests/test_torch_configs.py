"""The port's configs beyond llama and qwen3-0.6b against the JAX package,
live, on the CPU: the registry, the parameter trees, the bridge, the
frontend batches, and the training loss with every gradient leaf in the
four NDB modes.

``forward_loss`` runs as in ``tests/test_torch_train_loss.py`` (f32,
``MeCeFOConfig(rank=8)``, ``NDBPlan(n_dp=4, n_stages=2, failed={(1, 0)})``,
the JAX state with V1 across the bridge, rtol 1e-5 / atol 1e-6) for reduced
``qwen3-moe-30b-a3b`` (MoE: the aux loss joins the loss), ``granite-34b``
(gelu, MQA), ``nemotron-4-340b`` (relu2), ``phi-3-vision-4.2b`` (the
vision stub's patches) and ``musicgen-medium`` (the audio stub's frame
embeddings).  ``count_params`` for every registered config, full size and
reduced, is in ``tests/test_torch_ft.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import refresh_projections as jax_refresh  # noqa: E402
from repro.core.ndb import NDBContext as JaxContext  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.launch.state import init_state as jax_init_state  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import param_shapes as jax_param_shapes  # noqa: E402

from repro_torch.bridge import state_from_numpy, state_to_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import param_shapes, tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MODES = ["off", "dynamic", "static", "degraded"]
B, S, RANK = 8, 32, 8
PLAN = NDBPlan(n_dp=4, n_stages=2, failed=frozenset({(1, 0)}))
NEW = ["glm4-9b", "granite-34b", "nemotron-4-340b", "qwen3-moe-30b-a3b",
       "qwen3-moe-235b-a22b", "phi-3-vision-4.2b", "musicgen-medium"]
LOSS_CONFIGS = ["qwen3-moe-30b-a3b", "granite-34b", "nemotron-4-340b",
                "phi-3-vision-4.2b", "musicgen-medium"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, where torch's multi-threaded CPU kernels spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _close(a, b, what, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=atol, err_msg=what)


def _cfgs(name, **kw):
    return (jbase.reduced(jbase.get_config(name), **kw),
            tbase.reduced(tbase.get_config(name), **kw))


def _shapes(tree):
    """A JAX (shape, annotation) tree's shapes in the port's layout."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree[0])


def test_registry_holds_every_attention_config_of_the_jax_package():
    tbase.get_config("llama-350m")
    jbase.get_config("llama-350m")
    ssm = {n for n, c in jbase._REGISTRY.items() if c.family in ("ssm", "hybrid")}
    assert ssm == {"mamba2-2.7b", "jamba-1.5-large-398b"}
    # every config, the SSM and hybrid ones included (tests/test_torch_ssm.py)
    assert set(tbase._REGISTRY) == set(jbase._REGISTRY)
    for name, cfg in tbase._REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jbase._REGISTRY[name]), name


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NEW)
def test_param_shapes_match_jax(name, reduce):
    j, t = jbase.get_config(name), tbase.get_config(name)
    if reduce:
        j, t = jbase.reduced(j), tbase.reduced(t)
    assert param_shapes(t) == _shapes(jax_param_shapes(j))
    if t.moe is not None:
        ffn = param_shapes(t)["layers"][0]["ffn"]
        E, f = t.moe.n_experts, t.moe.d_ff_expert
        assert ffn["router"][1:] == (t.d_model, E)
        assert ffn["w_down"][1:] == (E, f, t.d_model)
    if t.ffn_act != "swiglu":
        assert "w_gate" not in param_shapes(t)["layers"][0]["ffn"]


def test_reduced_moe_matches_the_jax_reduction():
    j, t = _cfgs("qwen3-moe-30b-a3b")
    assert t.moe == tbase.MoEConfig(n_experts=8, top_k=2, d_ff_expert=64)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name", NEW)
def test_train_state_crosses_the_bridge_leaf_for_leaf(name):
    """JAX's bf16 TrainState (params, AdamW moments, V1) of the reduced
    config crosses to the port and back bitwise."""
    jcfg, tcfg = _cfgs(name)
    mec = jbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    jst = jax_init_state(jcfg, jbase.TrainConfig(), mec, jax.random.PRNGKey(0))
    jst = jst._replace(proj=jax_refresh(jst.params, jcfg, RANK))
    host = jax.tree.map(np.asarray, jst)
    tst = state_from_numpy(host, tcfg, device="cpu")
    assert tst.params["embed"].dtype == torch.bfloat16
    back = state_to_numpy(tst)
    for part in ("params", "proj"):
        a, b = jax.tree.leaves(getattr(host, part)), tree_leaves(getattr(back, part))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))
    for x, y in zip(jax.tree.leaves(host.opt.m), tree_leaves(back.opt.m)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_frontend_batches_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    shape = tbase.ShapeConfig("t", S, B, "train")
    jb = jax_make_batch(jcfg, jbase.ShapeConfig("t", S, B, "train"), step=3)
    tb = make_batch(tcfg, shape, step=3)
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_forward_loss_and_grads_match_jax(name, mode, local_rules):
    jcfg, tcfg = _cfgs(name, dtype="float32")
    mec = dict(mode="dynamic", rank=RANK)
    jst = jax_init_state(jcfg, jbase.TrainConfig(), jbase.MeCeFOConfig(**mec),
                         jax.random.PRNGKey(0))
    jst = jst._replace(proj=jax_refresh(jst.params, jcfg, RANK))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    batch = jax_make_batch(jcfg, jbase.ShapeConfig("t", S, B, "train"), step=0)
    keep, w = plan_to_masks(PLAN, tcfg, B)
    masked = mode in ("dynamic", "static")
    jctx = JaxContext(mode=mode, keep=jnp.asarray(keep) if masked else None,
                      example_weight=jnp.asarray(w) if masked else None,
                      mecefo=jbase.MeCeFOConfig(**mec))
    tctx = NDBContext(mode=mode, keep=torch.from_numpy(keep) if masked else None,
                      example_weight=torch.from_numpy(w) if masked else None,
                      mecefo=tbase.MeCeFOConfig(**mec))
    jflags = jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16)

    def jloss(p):
        return jmodel.forward_loss(p, jst.proj, jax.tree.map(jnp.asarray, batch), jcfg,
                                   local_rules, jctx, jflags)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jst.params)
    tl, tm, tg = loss_and_grads(tst.params, tst.proj,
                                {k: torch.from_numpy(v) for k, v in batch.items()},
                                tcfg, tctx, ExecFlags(remat="ffn", ce_chunk=16))
    _close(tl, jl, "loss")
    _close(tm["ce"], jm["ce"], "ce")
    _close(tm["aux"], jm["aux"], "aux")
    if tcfg.moe is not None:
        assert float(tm["aux"]) > 0
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert tuple(a.shape) == b.shape
        _close(a, b, f"grad leaf {i} {b.shape}")
    if mode == "degraded":  # technique I: no MHA weight gradient at all
        assert not any(g.any() for g in tg["layers"][0]["mixer"].values())
