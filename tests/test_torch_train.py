"""The training slice's pieces against the JAX package's, live, on the CPU.

Inputs come from numpy seeds and cross as numpy arrays.  Tolerances:
kernel #6 against the Pallas kernel follows ``tests/test_kernels.py`` (1e-4
f32, 0.05 bf16, relative to max |ref|); everything else runs in f32 and is held at rtol 1e-5 /
atol 1e-6, since both sides compute the same f32 arithmetic and differ only
in summation order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import grad_sync as jgrad_sync  # noqa: E402
from repro.core import lowrank as jlowrank  # noqa: E402
from repro.core import ndb as jndb  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.lowrank_wgrad import lowrank_wgrad_project as jax_project  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402

from repro_torch.bridge import params_from_numpy, tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import grad_sync, lowrank, ndb  # noqa: E402
from repro_torch.core.skipconn import cast_grad, grad_gate  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_plain  # noqa: E402
from repro_torch.kernels.lowrank_wgrad import (  # noqa: E402
    lowrank_wgrad, lowrank_wgrad_project, lowrank_wgrad_project_plain,
)
from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.swiglu import SwiGLUFn, swiglu_plain  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

RULES = ShardingRules(batch=(), embed=None, heads=None, kv_heads=None, mlp=None,
                      vocab=None, expert=None, ssm_inner=None)
RTOL, ATOL = 1e-5, 1e-6


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# copies: configs, data, NDB plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MeCeFOConfig", "TrainConfig", "ShapeConfig"])
def test_config_copies_match_jax(name):
    j, t = getattr(jbase, name), getattr(tbase, name)
    jf = [(f.name, f.default) for f in dataclasses.fields(j)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t)]
    assert tf == jf


@pytest.mark.parametrize("seed,vocab,step", [(0, 512, 0), (0, 32000, 3), (5, 500, 17)])
def test_synthetic_batches_bit_identical(seed, vocab, step):
    tcfg = tbase.reduced(tbase.get_config("llama-350m"), vocab_size=vocab)
    jcfg = jbase.reduced(jbase.get_config("llama-350m"), vocab_size=vocab)
    shape_t = tbase.ShapeConfig("t", 24, 6, "train")
    shape_j = jbase.ShapeConfig("t", 24, 6, "train")
    a = pipeline.make_batch(tcfg, shape_t, step, seed=seed)
    b = jpipeline.make_batch(jcfg, shape_j, step, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("B,n,active", [(8, 4, [0, 1, 2, 3]), (8, 4, [0, 2, 3]),
                                        (12, 4, [3]), (12, 6, [1, 4]), (8, 4, [])])
def test_rebalanced_owners_match_jax(B, n, active):
    assert np.array_equal(pipeline.rebalanced_owners(B, n, active),
                          jpipeline.rebalanced_owners(B, n, active))


PLANS = [
    dict(n_dp=4, n_stages=2, failed={(1, 0)}),
    dict(n_dp=4, n_stages=8, failed={(1, 3)}),
    dict(n_dp=4, n_stages=2, failed={(2, 0), (2, 1)}),          # a whole rank lost
    dict(n_dp=4, n_stages=2, failed={(0, 1)}, detached={3}),    # elastic
    dict(n_dp=2, n_stages=4, failed={(0, 0), (0, 3), (1, 2)}),
]


@pytest.mark.parametrize("plan", PLANS)
def test_plan_to_masks_match_jax(plan):
    kw = dict(plan, failed=frozenset(plan["failed"]),
              detached=frozenset(plan.get("detached", ())))
    tp, jp = ndb.NDBPlan(**kw), jndb.NDBPlan(**kw)
    assert tp.active_ranks() == jp.active_ranks()
    assert tp.signature() == jp.signature()
    for r in range(tp.n_dp):
        assert tp.degraded_stages(r) == jp.degraded_stages(r)
    for L in (2, 5, 24):
        tcfg = tbase.reduced(tbase.get_config("llama-350m"), n_layers=L)
        jcfg = jbase.reduced(jbase.get_config("llama-350m"), n_layers=L)
        for a, b in zip(ndb.plan_to_masks(tp, tcfg, 8), jndb.plan_to_masks(jp, jcfg, 8)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert [ndb.stage_of_layer(i, L, tp.n_stages) for i in range(L)] == \
            [jndb.stage_of_layer(i, L, jp.n_stages) for i in range(L)]


@pytest.mark.parametrize("knobs", [{}, {"lowrank_wgrad": False}, {"lowrank_sync": True},
                                   {"recompute_ffn": False}])
def test_ndb_context_logic_matches_jax(knobs):
    for mode in ("off", "dynamic", "static", "degraded"):
        t = ndb.NDBContext(mode=mode, mecefo=tbase.MeCeFOConfig(**knobs))
        j = jndb.NDBContext(mode=mode, mecefo=jbase.MeCeFOConfig(**knobs))
        assert (t.lowrank_mode(), t.recompute_ffn(), t.active) == \
            (j.lowrank_mode(), j.recompute_ffn(), j.active)
        if mode in ("off", "degraded"):
            assert t.keep_for_layer(0) == j.keep_for_layer(0)


def test_context_for_builds_masks_on_the_requested_device():
    cfg = tbase.reduced(tbase.get_config("llama-350m"))
    plan = ndb.NDBPlan(4, 2, frozenset({(1, 0)}))
    for mode in ("dynamic", "static"):
        ctx = ndb.context_for(tbase.MeCeFOConfig(mode=mode), plan, cfg, 8, device="cpu")
        keep, w = ndb.plan_to_masks(plan, cfg, 8)
        assert ctx.mode == mode and np.array_equal(ctx.keep.numpy(), keep)
        assert np.array_equal(ctx.example_weight.numpy(), w)
    assert ndb.context_for(tbase.MeCeFOConfig(mode="off"), plan, cfg, 8).mode == "off"


# ---------------------------------------------------------------------------
# kernel #6 and lowrank_linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,n,m,r,dt", [
    (300, 100, 260, 12, "bfloat16"),
    (100, 52, 130, 10, "bfloat16"),
    (260, 36, 412, 20, "float32"),
])
def test_lowrank_wgrad_plain_matches_pallas(t, n, m, r, dt):
    rng = np.random.default_rng(t + n + m)
    xj = jnp.asarray(rng.standard_normal((t, n)), dt)
    dyj = jnp.asarray(rng.standard_normal((t, m)), dt)
    vj = jnp.asarray(rng.standard_normal((n, r)), dt)
    xt, dyt, vt = _t(xj), _t(dyj), _t(vj)
    tol = 0.05 if dt == "bfloat16" else 1e-4
    # A = (x V1)^T dy: the Pallas kernel in interpret mode, on zero-padded
    # block multiples as kernels/ops.py pads them
    bt, bm = 128, 256
    pad_t, pad_m = -t % bt, -m % bm
    a_ref = jax_project(jnp.pad(xj, ((0, pad_t), (0, 0))), jnp.pad(dyj, ((0, pad_t), (0, pad_m))),
                        vj, block_t=bt, block_m=bm, interpret=True)[:, :m]
    a = lowrank_wgrad_project(xt, dyt, vt)
    assert a.dtype == torch.float32 and a.shape == (r, m)
    scale = float(np.abs(_np(a_ref)).max()) + 1e-6
    np.testing.assert_allclose(_np(a) / scale, _np(a_ref) / scale, atol=tol)
    # dW = V1 A, against the JAX wrapper
    dw_ref = jops.lowrank_wgrad(xj, dyj, vj, block_t=bt, block_m=bm, interpret=True)
    dw = lowrank_wgrad(xt, dyt, vt)
    assert dw.dtype == xt.dtype and dw.shape == (n, m)
    scale = float(np.abs(_np(dw_ref)).max()) + 1e-6
    np.testing.assert_allclose(_np(dw) / scale, _np(dw_ref) / scale, atol=tol)


@pytest.mark.parametrize("t,n,m,r", [(300, 100, 260, 12), (100, 52, 130, 10), (1024, 256, 300, 64)])
def test_lowrank_wgrad_limit_catches_p_rounded_to_bf16(t, n, m, r):
    """The card holds kernel #6 at 1e-4 of max |ref| against its plain
    version in bf16 too: a kernel that rounded P = x @ V1 to bf16 would
    miss that limit several times over."""
    rng = np.random.default_rng(t + r)
    x, dy, v = (_t(jnp.asarray(rng.standard_normal(s), "bfloat16"))
                for s in ((t, n), (t, m), (n, r)))
    ref = lowrank_wgrad_project_plain(x, dy, v)
    p_bf16 = (x.float() @ v.float()).to(torch.bfloat16).float()
    err = float((p_bf16.T @ dy.float() - ref).abs().max())
    assert err > 3e-4 * float(ref.abs().max())


@pytest.mark.parametrize("t,n,m,r", [(1024, 256, 300, 64), (300, 100, 260, 12)])
def test_lowrank_wgrad_split_p_within_card_limit_of_pallas(t, n, m, r):
    """The bf16 kernel's precision scheme, emulated in plain torch (P split
    into bf16 P_hi + P_lo, f32 products and sums), against the Pallas
    kernel in interpret mode (f32 P): within the card's limit, 1e-4 of
    max |ref|, which the same emulation with P rounded once to bf16 misses."""
    rng = np.random.default_rng(t + n + m + r)
    xj, dyj, vj = (jnp.asarray(rng.standard_normal(s), "bfloat16")
                   for s in ((t, n), (t, m), (n, r)))
    bt, bm = 128, 256
    pad_t, pad_m = -t % bt, -m % bm
    a_ref = _np(jax_project(jnp.pad(xj, ((0, pad_t), (0, 0))),
                            jnp.pad(dyj, ((0, pad_t), (0, pad_m))), vj,
                            block_t=bt, block_m=bm, interpret=True)[:, :m])
    scale = float(np.abs(a_ref).max())
    x, dy, v = _t(xj), _t(dyj), _t(vj)
    split = _np(lowrank_wgrad_project_plain(x, dy, v, p_precision="split"))
    assert float(np.abs(split - a_ref).max()) <= 1e-4 * scale
    once = _np(lowrank_wgrad_project_plain(x, dy, v, p_precision="bf16"))
    assert float(np.abs(once - a_ref).max()) > 1e-4 * scale


def test_lowrank_wgrad_cpu_takes_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    x, dy, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((33, 7), (33, 9), (7, 3)))
    before = lowrank_wgrad_project.launches
    assert torch.equal(lowrank_wgrad_project(x, dy, v), lowrank_wgrad_project_plain(x, dy, v))
    assert lowrank_wgrad_project.launches == before


@pytest.mark.parametrize("mode", ["exact", "degraded", "degraded_sync", "mixed"])
def test_lowrank_linear_matches_jax_vjp(mode):
    rng = np.random.default_rng(11)
    B, S, n, m, r = 4, 6, 20, 30, 5
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    w = (rng.standard_normal((n, m)) / np.sqrt(n)).astype(np.float32)
    v1 = np.linalg.qr(rng.standard_normal((n, r)))[0].astype(np.float32)
    keep = np.array([1, 0, 1, 0], np.float32)
    dy = rng.standard_normal((B, S, m)).astype(np.float32)

    y_j, vjp = jax.vjp(lambda x, w: jlowrank.lowrank_linear(x, w, jnp.asarray(v1),
                                                           jnp.asarray(keep), mode),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))

    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y_t = lowrank.lowrank_linear(xt, wt, torch.from_numpy(v1), torch.from_numpy(keep), mode)
    dx_t, dw_t = torch.autograd.grad(y_t, (xt, wt), torch.from_numpy(dy))
    _close(y_t, y_j)
    _close(dx_t, dx_j)
    _close(dw_t, dw_j)
    assert dw_t.dtype == wt.dtype


def test_lowrank_linear_dx_exact_and_dw_dtype_in_bf16():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32)).bfloat16()
    v1 = lowrank.svd_projection(w, 4)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    dy = torch.ones(3, 5, 24, dtype=torch.bfloat16)
    dx, dw = torch.autograd.grad(lowrank.lowrank_linear(xr, wr, v1, 0.0, "degraded"),
                                 (xr, wr), dy)
    assert torch.equal(dx, dy @ w.T) and dw.dtype == torch.bfloat16 and v1.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,rank", [((24, 40), 6), ((2, 40, 24), 8), ((3, 16, 16), 32)])
def test_svd_projection_spans_the_jax_subspace(shape, rank):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    vt = lowrank.svd_projection(torch.from_numpy(w), rank)
    vj = np.asarray(jlowrank.svd_projection(jnp.asarray(w), rank))
    assert vt.shape == vj.shape
    # the columns' signs differ between the two libraries: compare V1 V1^T
    pt = _np(vt) @ np.swapaxes(_np(vt), -1, -2)
    pj = vj @ np.swapaxes(vj, -1, -2)
    np.testing.assert_allclose(pt, pj, atol=1e-5)


def test_projections_start_at_zero_and_refresh_to_svd():
    jcfg = jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    tcfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    jp = jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    zeros_t = lowrank.init_projections(tp, tcfg, 8)
    zeros_j = jlowrank.init_projections(jp, jcfg, 8)
    lt, lj = tree_leaves(zeros_t), jax.tree.leaves(zeros_j)
    assert [tuple(a.shape) for a in lt] == [a.shape for a in lj]
    assert all(not a.any() for a in lt)
    for a, b in zip(tree_leaves(lowrank.refresh_projections(tp, tcfg, 8)),
                    jax.tree.leaves(jlowrank.refresh_projections(jp, jcfg, 8))):
        np.testing.assert_allclose(_np(a) @ np.swapaxes(_np(a), -1, -2),
                                   np.asarray(b) @ np.swapaxes(np.asarray(b), -1, -2), atol=1e-5)


def test_wgrad_flops_match_jax():
    for args in ((8192, 1024, 2736, 64), (100, 7, 9, None), (1, 1, 1, 1)):
        assert lowrank.wgrad_flops(*args) == jlowrank.wgrad_flops(*args)


# ---------------------------------------------------------------------------
# techniques I and II, eq. (1), CE, optimizer
# ---------------------------------------------------------------------------


def test_grad_gate_scales_the_cotangent_per_example():
    x = torch.randn(3, 4, 5, requires_grad=True)
    keep = torch.tensor([1.0, 0.0, 0.5])
    y = grad_gate(x, keep)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, keep[:, None, None].expand(3, 4, 5))
    (g,) = torch.autograd.grad(grad_gate(x, 0.25).sum(), x)
    assert torch.equal(g, torch.full_like(x, 0.25))


def test_autograd_casts_cotangents_so_cast_grad_is_the_identity():
    x = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    y = cast_grad(x)
    assert y is x
    (g,) = torch.autograd.grad((y.float() * 3.0).sum(), x)
    assert g.dtype == torch.bfloat16


@pytest.mark.parametrize("policy", ["nothing", "none"])
def test_recompute_saves_only_inputs_and_keeps_gradients(policy):
    from repro_torch.core.recompute import maybe_remat

    w = torch.randn(6, 6, requires_grad=True)
    x = torch.randn(4, 6, requires_grad=True)

    def fn(x, w):
        return torch.tanh(x @ w) @ w

    assert maybe_remat(fn, False) is fn
    with pytest.raises(ValueError, match="remat policy"):
        maybe_remat(fn, True, "dots_and_more")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = maybe_remat(fn, True, policy)(x, w)
    got = torch.autograd.grad(y.square().sum(), [x, w])
    want = torch.autograd.grad(fn(x, w).square().sum(), [x, w])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(saved) == 2  # the checkpoint keeps x and w, nothing inside fn
    assert maybe_remat(fn, True, policy)(x.detach(), w.detach()).grad_fn is None


def test_degraded_attention_branch_records_nothing():
    cfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    from repro_torch.models.params import init_params

    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mixer = {k: t[0].detach().requires_grad_() for k, t in p["layers"][0]["mixer"].items()}
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    pos = torch.arange(8)
    out, _ = layers.attention_block(mixer, x, cfg, pos, keep=0.0)
    grads = torch.autograd.grad(out.sum(), [x, *mixer.values()], allow_unused=True)
    assert torch.equal(grads[0], torch.ones_like(x))  # residual only
    assert all(g is None for g in grads[1:])          # no MHA backward at all
    out1, _ = layers.attention_block(mixer, x, cfg, pos, keep=1.0)
    assert torch.equal(out1.detach(), out)


def _jax_grads_tree(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jparams.param_shapes(cfg)
    return jax.tree.map(lambda e: rng.standard_normal(e[0]).astype(np.float32), shapes,
                        is_leaf=jparams._is_entry)


@pytest.mark.parametrize("plan", [
    dict(n_dp=4, n_stages=2, failed={(0, 1)}, detached={3}),   # elastic resize
    dict(n_dp=4, n_stages=2, failed={(2, 0), (2, 1), (1, 1)}),  # whole-rank loss
    dict(n_dp=2, n_stages=2, failed={(0, 0), (1, 0)}),          # a layer nobody kept
])
def test_eq1_rescale_matches_jax(plan):
    jcfg = jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    tcfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    kw = dict(plan, failed=frozenset(plan["failed"]), detached=frozenset(plan.get("detached", ())))
    keep, w = ndb.plan_to_masks(ndb.NDBPlan(**kw), tcfg, 8)
    if plan.get("detached"):
        assert w.min() == 1.0  # the batch is repartitioned, not lost
    grads = _jax_grads_tree(jcfg, 3)
    ref = jgrad_sync.rescale_skipped_grads(grads, jnp.asarray(keep), jcfg, jnp.asarray(w))
    got = grad_sync.rescale_skipped_grads(params_from_numpy(grads, tcfg, "cpu"),
                                          torch.from_numpy(keep), tcfg, torch.from_numpy(w))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        _close(a, b)
    ref = jgrad_sync.rescale_skipped_grads(grads, jnp.asarray(keep), jcfg)
    got = grad_sync.rescale_skipped_grads(params_from_numpy(grads, tcfg, "cpu"),
                                          torch.from_numpy(keep), tcfg)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        _close(a, b)


@pytest.mark.parametrize("vocab,padded", [(500, 512), (1000, 1024)])
def test_chunked_ce_masks_pad_vocab_like_jax(vocab, padded):
    rng = np.random.default_rng(vocab)
    B, S, d = 3, 16, 24
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    un = rng.standard_normal((d, padded)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tw = (rng.random((B, S)) > 0.2).astype(np.float32)

    def jloss(h, un):
        return jlayers.chunked_cross_entropy(h, un, jnp.asarray(labels), jnp.asarray(tw), RULES,
                                             chunk=4, vocab_size=vocab)

    lj, (ghj, guj) = jax.value_and_grad(jloss, argnums=(0, 1))(h, un)
    ht, ut = torch.from_numpy(h).requires_grad_(), torch.from_numpy(un).requires_grad_()
    lt = layers.chunked_cross_entropy(ht, ut, torch.from_numpy(labels), torch.from_numpy(tw),
                                      chunk=4, vocab_size=vocab)
    ght, gut = torch.autograd.grad(lt, (ht, ut))
    _close(lt, lj)
    _close(ght, ghj)
    _close(gut, guj)
    assert not gut[:, vocab:].any()  # pad columns take no gradient


def test_adamw_and_sgdm_match_jax():
    jcfg = jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    tcfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2)
    params = _jax_grads_tree(jcfg, 0)
    for opt in ("adamw", "sgdm"):
        jt = jbase.TrainConfig(optimizer=opt)
        tt = tbase.TrainConfig(optimizer=opt)
        jstate = joptim.init_opt_state(params, jt)
        jp = jax.tree.map(jnp.asarray, params)
        tp = params_from_numpy(params, tcfg, "cpu")
        tstate = optimizers.init_opt_state(tp, tt)
        sched_j, sched_t = joptim.lr_schedule(jt, 20), optimizers.lr_schedule(tt, 20)
        for step in range(4):
            g = _jax_grads_tree(jcfg, 10 + step)
            gj, nj = joptim.clip_by_global_norm(g, 1.0)
            gt, nt = optimizers.clip_by_global_norm(params_from_numpy(g, tcfg, "cpu"), 1.0)
            _close(nt, nj)
            assert sched_t(step) == pytest.approx(float(sched_j(step)), rel=1e-6)
            jp, jstate = joptim.apply_update(jp, gj, jstate, sched_j(step), jnp.int32(step), jt)
            tp, tstate = optimizers.apply_update(tp, gt, tstate, sched_t(step), step, tt)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            _close(a, b)
        for a, b in zip(tree_leaves(tstate.m), jax.tree.leaves(jstate.m)):
            _close(a, b)


@pytest.mark.parametrize("total", [10, 37, 1000])
def test_lr_schedule_matches_jax(total):
    jt, tt = jbase.TrainConfig(), tbase.TrainConfig()
    sj, st = joptim.lr_schedule(jt, total), optimizers.lr_schedule(tt, total)
    for step in sorted({0, 1, 2, total // 10, total // 2, total - 1, total + 5}):
        assert st(step) == pytest.approx(float(sj(step)), rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# the repair: each kernel's autograd Function against plain autograd
# ---------------------------------------------------------------------------


def _fn_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return [
        ("rmsnorm", lambda x, s: RMSNormFn.apply(x, s, 1e-5),
         lambda x, s: rmsnorm_plain(x, s, 1e-5), (r(3, 7, 32), r(32))),
        ("swiglu", SwiGLUFn.apply, swiglu_plain, (r(5, 48), r(5, 48))),
        ("flash_attention", FlashAttentionFn.apply, flash_attention_plain,
         (r(2, 9, 4, 32), r(2, 9, 2, 32), r(2, 9, 2, 32))),
    ]


@pytest.mark.parametrize("case", _fn_cases(), ids=lambda c: c[0])
def test_kernel_function_gradients_match_plain_autograd(case):
    _name, fn, plain, inputs = case
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    ya, yb = fn(*a), plain(*b)
    assert ya.grad_fn is not None and torch.equal(ya, yb)
    go = torch.randn(ya.shape, generator=torch.Generator().manual_seed(1))
    for ga, gb in zip(torch.autograd.grad(ya, a, go), torch.autograd.grad(yb, b, go)):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)
    # only the inputs that need it get a gradient
    a[0].requires_grad_(False)
    (gk,) = torch.autograd.grad(fn(*a), a[1:2], go)
    assert gk.shape == a[1].shape
