"""The port's Mamba2 mixer (``repro_torch.models.ssm``) and the SSM and
hybrid configs against the JAX package, live, on the CPU, at f32.

* ``_causal_conv``, ``ssd_chunked`` (also with an S that forces the
  ``S % Q`` fallback, and with an initial state) and ``ssd_decode``
  against the JAX functions, within 1e-5;
* ``ssm_block``'s output and gradients (input, every leaf) in ``exact``,
  ``degraded``, ``degraded_sync`` and ``mixed``, with and without
  recompute, against ``jax.vjp`` of the JAX block;
* the loss and every gradient leaf of ``forward_loss`` for ``tiny-ssm`` and
  ``tiny-hybrid`` (the copies of ``tests/conftest.py``'s) in the four NDB
  modes; the zero-width FFN leaves get zero gradients;
* prefill then decode equal to the whole prompt's prefill, and prefill and
  decode logits against JAX's;
* ``count_params`` and ``param_shapes`` of mamba2-2.7b and jamba, the
  bridge round trip with SSM leaves, the seeded init's SSM leaves, and
  three ``make_train_step`` steps of ``tiny-ssm`` against the JAX step.

rtol 1e-5 / atol 1e-6 on losses; the block's gradients within 1e-5 of each
leaf's largest element, the trunk's within TRUNK_TOL of each leaf's norm:
the same f32 arithmetic, summed in other orders (the per-head leaves
``A_log``, ``dt_bias`` and ``D`` sum over every position and cancel).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import refresh_projections as jax_refresh  # noqa: E402
from repro.core.ndb import NDBContext as JaxContext  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.state import init_state as jax_init_state  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.kvcache import cache_structs as jax_cache_structs  # noqa: E402
from repro.models.params import count_params as jax_count_params  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import param_shapes as jax_param_shapes  # noqa: E402

from repro_torch.bridge import (  # noqa: E402
    params_from_numpy, state_from_numpy, state_to_numpy, tensor_from_numpy, tensor_to_numpy,
)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.lowrank import refresh_projections  # noqa: E402
from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import ExecFlags, forward_decode, forward_prefill  # noqa: E402
from repro_torch.models.params import count_params, init_params, param_shapes, tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
# the trunk's gradient leaves, ||Δ|| / ||g|| per leaf: the per-head A_log
# gradient of a hybrid SSM layer cancels to 1 % of the other leaves' norms
# and lands 1.04e-4 from JAX's (tiny-hybrid, dynamic); 7.2e-6 elsewhere
TRUNK_TOL = 2e-4
MODES = ["off", "dynamic", "static", "degraded"]
LOWRANK_MODES = ["exact", "degraded", "degraded_sync", "mixed"]
B, S, RANK = 4, 32, 8
PLAN = NDBPlan(n_dp=2, n_stages=2, failed=frozenset({(1, 0)}))
# the copies of tests/conftest.py's TINY_SSM and TINY_HYBRID
TINY = {
    "tiny-ssm": dict(name="tiny-ssm", family="ssm", n_layers=4, d_model=64, n_heads=1,
                     n_kv_heads=1, d_ff=0, vocab_size=256, dtype="float32",
                     ssm=dict(d_state=16, head_dim=16, chunk=8)),
    "tiny-hybrid": dict(name="tiny-hybrid", family="hybrid", n_layers=8, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
                        attn_every=4,
                        moe=dict(n_experts=4, top_k=2, d_ff_expert=32, every=2, offset=1,
                                 capacity_factor=4.0),
                        ssm=dict(d_state=16, head_dim=16, chunk=8)),
}


@pytest.fixture(autouse=True)
def jax_zero_width_ffn_exact(monkeypatch):
    """The JAX package's low-rank backward (``repro/core/lowrank.py``
    ``_ll_bwd``) reshapes ``dy`` to ``(-1, m)``, which raises for m = 0:
    mamba2's zero-width FFN cannot take a low-rank step there.  For a
    zero-width FFN the exact and the low-rank weight gradient are the same
    empty array, so the JAX side runs such an FFN exact (V1 withheld);
    the port takes its low-rank path on it unchanged."""
    orig = jmodel.ffn_block

    def ffn_block(p, h, cfg, rules, *, proj=None, **kw):
        if cfg.d_ff == 0:
            proj = None
        return orig(p, h, cfg, rules, proj=proj, **kw)

    monkeypatch.setattr(jmodel, "ffn_block", ffn_block)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, where torch's multi-threaded CPU kernels spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(name):
    kw = dict(TINY[name])
    out = []
    for base in (jbase, tbase):
        sub = {k: getattr(base, cls)(**kw[k]) for k, cls in
               (("moe", "MoEConfig"), ("ssm", "SSMConfig")) if k in kw}
        out.append(base.ModelConfig(**{**kw, **sub}))
    return tuple(out)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x.detach()).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=what)


def _close_max(a, b, what, tol=1e-5):
    """|a - b| <= tol * max |b| elementwise: a gradient summed over every
    position (``A_log``, ``dt_bias``, ``D``) cancels, so its small elements
    carry the whole leaf's summation noise."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(float(np.abs(b).max()), 1e-30),
                               err_msg=what)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _scan_inputs(seed, Bz, Sz, nh, hd, N):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bz, Sz, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, Sz, nh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    b = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    c = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    h0 = rng.standard_normal((Bz, nh, N, hd)).astype(np.float32)
    return xh, dt, a_log, b, c, h0


# ---------------------------------------------------------------------------
# the scan, the conv and the decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,chunk,with_h0", [(32, 8, False), (12, 8, False), (24, 8, True)],
                         ids=["chunks", "fallback", "h0"])
def test_ssd_chunked_matches_jax(seq, chunk, with_h0):
    """S 12 with chunk 8 falls back to Q 6 (the largest divisor)."""
    xh, dt, a_log, b, c, h0 = _scan_inputs(1, 2, seq, 4, 8, 16)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(v) for v in (xh, dt, a_log, b, c)), chunk,
                              h0=jnp.asarray(h0) if with_h0 else None)
    ty, th = tssm.ssd_chunked(*(_t(v) for v in (xh, dt, a_log, b, c)), chunk,
                              h0=_t(h0) if with_h0 else None)
    _close(ty, jy, "y", atol=1e-5)
    _close(th, jh, "h_final", atol=1e-5)


def test_ssd_decode_and_causal_conv_match_jax():
    xh, dt, a_log, b, c, h0 = _scan_inputs(2, 3, 1, 4, 8, 16)
    jy, jh = jssm.ssd_decode(*(jnp.asarray(v) for v in (xh[:, 0], dt[:, 0], a_log, b[:, 0],
                                                        c[:, 0], h0)))
    ty, th = tssm.ssd_decode(*(_t(v) for v in (xh[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], h0)))
    _close(ty, jy, "decode y", atol=1e-5)
    _close(th, jh, "decode h", atol=1e-5)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 10, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal((12,)).astype(np.float32)
    _close(tssm._causal_conv(_t(u), _t(w), _t(bias)),
           jssm._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(bias)), "conv",
           atol=1e-5)


def test_ssd_chunked_gradients_are_finite_and_match_jax():
    """The mask before ``exp``: the backward holds no inf * 0."""
    xh, dt, a_log, b, c, _ = _scan_inputs(4, 2, 16, 2, 8, 8)
    ct = np.random.default_rng(5).standard_normal(xh.shape).astype(np.float32)

    def jfn(xh, dt, b, c):
        return jssm.ssd_chunked(xh, dt, jnp.asarray(a_log), b, c, 8)[0]

    _, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in (xh, dt, b, c)))
    jg = vjp(jnp.asarray(ct))
    ts = [_t(v).requires_grad_() for v in (xh, dt, b, c)]
    y, _ = tssm.ssd_chunked(ts[0], ts[1], _t(a_log), ts[2], ts[3], 8)
    tg = torch.autograd.grad(y, ts, _t(ct))
    for name, a, bb in zip(("xh", "dt", "b", "c"), tg, jg):
        assert torch.isfinite(a).all(), name
        _close_max(a, bb, name)


# ---------------------------------------------------------------------------
# ssm_block
# ---------------------------------------------------------------------------


def _block(seed=0):
    jcfg, tcfg = _tiny("tiny-ssm")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    jproj = jax_refresh(jp, jcfg, RANK)["layers"][0]["mixer"]
    jm = {k: v[0] for k, v in jp["layers"][0]["mixer"].items()}
    jpj = {k: v[0] for k, v in jproj.items()}
    tm = {k: _t(v) for k, v in jm.items()}
    tpj = {k: _t(v) for k, v in jpj.items()}
    return jcfg, tcfg, jm, tm, jpj, tpj


@pytest.mark.parametrize("recompute", [False, True], ids=["saved", "recompute"])
@pytest.mark.parametrize("mode", LOWRANK_MODES)
def test_ssm_block_output_and_gradients_match_jax(mode, recompute, local_rules):
    jcfg, tcfg, jm, tm, jpj, tpj = _block()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    keep = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(p, x):
        return jssm.ssm_block(p, x, jcfg, local_rules, proj=jpj, keep=jnp.asarray(keep),
                              lowrank_mode=mode, recompute=recompute)[0]

    jy, vjp = jax.vjp(jfn, jm, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    tp = {k: v.clone().requires_grad_() for k, v in tm.items()}
    tx = _t(x).requires_grad_()
    ty, _ = tssm.ssm_block(tp, tx, tcfg, proj=tpj, keep=torch.from_numpy(keep),
                           lowrank_mode=mode, recompute=recompute)
    _close(ty, jy, "y", atol=1e-5)
    names = sorted(tp)
    got = torch.autograd.grad(ty, [tx] + [tp[k] for k in names], _t(ct))
    _close_max(got[0], jgx, "dx")
    for k, g in zip(names, got[1:]):
        _close_max(g, jgp[k], f"d{k}")


# ---------------------------------------------------------------------------
# the trunk: loss and every gradient leaf, prefill and decode
# ---------------------------------------------------------------------------


def _state(name, seed=0):
    jcfg, tcfg = _tiny(name)
    mec = jbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    st = jax_init_state(jcfg, jbase.TrainConfig(), mec, jax.random.PRNGKey(seed))
    st = st._replace(proj=jax_refresh(st.params, jcfg, RANK))
    tst = state_from_numpy(jax.tree.map(np.asarray, st), tcfg, device="cpu")
    return jcfg, tcfg, st, tst


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(TINY))
def test_forward_loss_and_grads_match_jax(name, mode, local_rules):
    jcfg, tcfg, jst, tst = _state(name)
    batch = SyntheticLM(tcfg.vocab_size).batch(0, B, S)
    keep, w = plan_to_masks(PLAN, tcfg, B)
    masked = mode in ("dynamic", "static")
    jctx = JaxContext(mode=mode, keep=jnp.asarray(keep) if masked else None,
                      example_weight=jnp.asarray(w) if masked else None,
                      mecefo=jbase.MeCeFOConfig(mode="dynamic", rank=RANK))
    tctx = NDBContext(mode=mode, keep=torch.from_numpy(keep) if masked else None,
                      example_weight=torch.from_numpy(w) if masked else None,
                      mecefo=tbase.MeCeFOConfig(mode="dynamic", rank=RANK))
    jflags = jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16)

    def jloss(p):
        return jmodel.forward_loss(p, jst.proj, jax.tree.map(jnp.asarray, batch), jcfg,
                                   local_rules, jctx, jflags)

    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jst.params)
    tl, tmet, tg = loss_and_grads(tst.params, tst.proj,
                                  {k: torch.from_numpy(v) for k, v in batch.items()},
                                  tcfg, tctx, ExecFlags(remat="ffn", ce_chunk=16))
    _close(tl, jl, "loss")
    _close(tmet["aux"], jmet["aux"], "aux")
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert tuple(a.shape) == b.shape
        ref = float(np.linalg.norm(_np(b)))
        if ref == 0:  # the zero-width FFN's norm, degraded MHA weights
            assert not _np(a).any(), f"grad leaf {i} {b.shape}"
        else:
            err = float(np.linalg.norm(_np(a) - _np(b))) / ref
            assert err <= TRUNK_TOL, f"grad leaf {i} {b.shape}: {err}"
    if tcfg.d_ff == 0:  # the zero-width FFN: zero-size leaves, the norm's gradient zero
        ffn = tg["layers"][0]["ffn"]
        assert ffn["w_up"].numel() == 0 and ffn["w_down"].numel() == 0
        assert ffn["ln"].numel() > 0 and not ffn["ln"].any()


@pytest.mark.parametrize("name", list(TINY))
def test_prefill_then_decode_matches_the_full_prefill_and_jax(name, local_rules):
    """``tests/test_models.py:test_prefill_decode_matches_full`` on the
    port, and each call's logits against JAX's."""
    jcfg, tcfg = _tiny(name)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    jflags = jmodel.ExecFlags(remat="none", attn_chunk=8, ce_chunk=16)
    _, full = forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              cache_structs(tcfg, 2, S))
    _, jfull = jmodel.forward_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, local_rules,
                                      jflags, jax_cache_structs(jcfg, 2, S, jnp.float32))
    _close(full, jfull, "full prefill logits", atol=1e-4)
    caches, _ = forward_prefill(tp, {"tokens": torch.from_numpy(toks[:, :S - 4])}, tcfg,
                                cache_structs(tcfg, 2, S))
    jcaches, _ = jmodel.forward_prefill(jp, {"tokens": jnp.asarray(toks[:, :S - 4])}, jcfg,
                                        local_rules, jflags,
                                        jax_cache_structs(jcfg, 2, S, jnp.float32))
    for t in range(S - 4, S):
        caches, logits = forward_decode(tp, caches, torch.from_numpy(toks[:, t]), t, tcfg)
        jcaches, jlogits = jmodel.forward_decode(jp, jcaches, jnp.asarray(toks[:, t]),
                                                 jnp.int32(t), jcfg, local_rules, jflags)
        _close(logits, jlogits, f"decode logits at {t}", atol=1e-4)
    np.testing.assert_allclose(_np(logits), _np(full), atol=2e-4)
    for te, je in zip(caches, jcaches):
        for k in te:
            _close(te[k], je[k], f"cache {k}", atol=1e-4)


# ---------------------------------------------------------------------------
# configs, parameter trees, the bridge and the step
# ---------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree[0])


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_configs_shapes_and_counts_match_jax(name):
    j, t = jbase.get_config(name), tbase.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for jc, tc in ((j, t), (jbase.reduced(j), tbase.reduced(t))):
        assert param_shapes(tc) == _shapes(jax_param_shapes(jc))
        assert count_params(tc) == jax_count_params(jc)
        assert count_params(tc, active_only=True) == jax_count_params(jc, active_only=True)
    if name == "mamba2-2.7b":
        ffn = param_shapes(t)["layers"][0]["ffn"]
        assert ffn == {"ln": (64, 2560), "w_up": (64, 2560, 0), "w_gate": (64, 2560, 0),
                       "w_down": (64, 0, 2560)}
        assert t.padded_vocab == 50304 and round(count_params(t) / 1e9, 2) == 2.70


@pytest.mark.parametrize("name", list(TINY))
def test_ssm_state_crosses_the_bridge_and_init_follows_the_reference(name):
    jcfg, tcfg, jst, tst = _state(name)
    back = state_to_numpy(tst)
    host = jax.tree.map(np.asarray, jst)
    for part in ("params", "proj"):
        a, b = jax.tree.leaves(getattr(host, part)), tree_leaves(getattr(back, part))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))
    own = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    pos = next(i for i, (kind, _) in enumerate(
        (tcfg.layer_kind(p), 0) for p in range(tcfg.block_period)) if kind == "ssm")
    mixer, jmixer = own["layers"][pos]["mixer"], host.params["layers"][pos]["mixer"]
    for k in ("A_log", "D", "dt_bias", "conv_b", "gate_norm", "ln"):
        np.testing.assert_allclose(_np(mixer[k]), jmixer[k], rtol=1e-6, err_msg=k)
    fan_in = mixer["in_proj"].shape[-2]
    assert abs(float(mixer["in_proj"].std()) * math.sqrt(fan_in) - 1) < 0.1
    proj = refresh_projections(tst.params, tcfg, RANK)
    for x, y in zip(tree_leaves(proj), jax.tree.leaves(host.proj)):
        assert tuple(x.shape) == y.shape


def test_tiny_ssm_train_steps_match_jax():
    """Three ``make_train_step`` steps of tiny-ssm in dynamic mode against
    the JAX step on ``make_host_mesh()``: loss, params and moments."""
    jcfg, tcfg, jst, tst = _state("tiny-ssm")
    tc = jbase.TrainConfig()
    shape = jbase.ShapeConfig("t", S, B, "train")
    keep, w = plan_to_masks(PLAN, tcfg, B)
    jstep, *_ = jax_make_train_step(
        jcfg, tc, jbase.ParallelConfig(remat="ffn"),
        jbase.MeCeFOConfig(mode="dynamic", rank=RANK), make_host_mesh(), shape,
        ndb_mode="dynamic", flags=jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16),
        donate=False)
    tstep = make_train_step(tcfg, tbase.TrainConfig(), tbase.MeCeFOConfig(mode="dynamic", rank=RANK),
                            tbase.ShapeConfig("t", S, B, "train"), ndb_mode="dynamic",
                            flags=ExecFlags(remat="ffn", ce_chunk=16), device="cpu")
    src = SyntheticLM(tcfg.vocab_size)
    ndb = {"keep": keep, "example_weight": w}
    for i in range(3):
        batch = src.batch(i, B, S)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, batch),
                        jax.tree.map(jnp.asarray, ndb))
        tst, tm = tstep(tst, batch, ndb)
        _close(tm["loss"], jm["loss"], f"step {i} loss")
        _close(tm["grad_norm"], jm["grad_norm"], f"step {i} grad norm", rtol=1e-4)
        for j, (x, y) in enumerate(zip(tree_leaves(tst.params), jax.tree.leaves(jst.params))):
            _close(x, y, f"step {i} param {j}", atol=1e-5)
        for j, (x, y) in enumerate(zip(tree_leaves(tst.opt.m), jax.tree.leaves(jst.opt.m))):
            _close(x, y, f"step {i} m {j}", atol=1e-5)
