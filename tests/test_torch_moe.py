"""The port's Mixture-of-Experts block, grouped low-rank linear and
non-gated activations against the JAX package's, live, on the CPU.

* ``moe_block`` at f32 on reduced qwen3-moe-30b-a3b (8 experts, top-2,
  ``d_ff_expert`` 64), JAX's weights bridged: the output and the aux loss
  (rtol 1e-5), the routing (expert ids against ``lax.top_k`` on JAX's
  router logits) and the capacity drops (against a numpy count of each
  slot's place in its expert's group), at the default capacity factor and
  at one low enough that slots drop; its gradients in the three technique
  III modes against ``jax.vjp``;
* ``lowrank_linear_grouped``'s gradients in ``exact``, ``degraded`` and
  ``mixed`` against ``jax.vjp`` of the JAX function;
* ``nonlin`` (``relu2``, ``gelu``) against the JAX ``nonlin``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import lowrank_linear_grouped as jax_llg  # noqa: E402
from repro.core.lowrank import refresh_projections as jax_refresh  # noqa: E402
from repro.models.layers import nonlin as jax_nonlin  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.models.moe import moe_block as jax_moe_block  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402

from repro_torch.bridge import params_from_numpy, tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.lowrank import lowrank_linear_grouped  # noqa: E402
from repro_torch.core.lowrank import refresh_projections  # noqa: E402
from repro_torch.models.layers import nonlin  # noqa: E402
from repro_torch.models.moe import bucketize, capacity, moe_block, route  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
B, S, RANK = 2, 12, 8
NAME = "qwen3-moe-30b-a3b"



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
        return tensor_to_numpy(x.detach()).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=what)


def _layer(cf):
    """Both configs at capacity factor ``cf`` and layer 0's FFN params on
    both sides, with V1 of rank ``RANK``."""
    jcfg = jbase.reduced(jbase.get_config(NAME), dtype="float32")
    tcfg = tbase.reduced(tbase.get_config(NAME), dtype="float32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jproj = jax_refresh(jp, jcfg, RANK)["layers"][0]["ffn"]
    jffn = {k: v[0] for k, v in jp["layers"][0]["ffn"].items()}
    tffn = {k: v[0].clone() for k, v in tp["layers"][0]["ffn"].items()}
    jpj = {k: v[0] for k, v in jproj.items()}
    tpj = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jpj.items()}
    return jcfg, tcfg, jffn, tffn, jpj, tpj


def _x(d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
def test_moe_block_forward_routing_and_drops_match_jax(cf, local_rules):
    jcfg, tcfg, jffn, tffn, _, _ = _layer(cf)
    x = _x(tcfg.d_model)
    jy, jaux = jax_moe_block(jffn, jnp.asarray(x), jcfg, local_rules)
    ty, taux = moe_block(tffn, torch.from_numpy(x), tcfg)
    _close(ty, jy, "y")
    _close(taux, jaux, "aux")

    # routing: JAX's lax.top_k over JAX's router logits
    T, k, E = B * S, tcfg.moe.top_k, tcfg.moe.n_experts
    xn = jax_rmsnorm(jnp.asarray(x), jffn["ln"], jcfg.norm_eps).reshape(T, -1)
    jlogits = jnp.einsum("td,de->te", xn.astype(jnp.float32), jffn["router"])
    _, jidx = jax.lax.top_k(jlogits, k)
    txn = torch.from_numpy(np.array(xn))
    _, _, tidx = route(txn, tffn["router"], k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    # drops: a slot is kept when its place among its expert's slots, in
    # slot order, is under the capacity
    cap = capacity(tcfg, T)
    assert cap == int(max(k, -(-T * k * cf // E)))
    e_flat = np.asarray(jidx).reshape(-1)
    place = np.array([(e_flat[:i] == e).sum() for i, e in enumerate(e_flat)])
    buf_src, slot_dst = bucketize(tidx.reshape(-1), E, cap)
    np.testing.assert_array_equal(slot_dst.numpy() >= 0, place < cap)
    kept = slot_dst.numpy()[place < cap]
    np.testing.assert_array_equal(kept, e_flat[place < cap] * cap + place[place < cap])
    assert sorted(buf_src.numpy()[buf_src.numpy() < T * k]) == sorted(np.flatnonzero(place < cap))
    if cf < 1:
        assert (place >= cap).sum() > 3  # the low factor drops more slots


@pytest.mark.parametrize("mode", ["exact", "degraded", "mixed"])
def test_moe_block_grads_match_jax_vjp(mode, local_rules):
    jcfg, tcfg, jffn, tffn, jpj, tpj = _layer(0.5)
    x = _x(tcfg.d_model, seed=1)
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    keep = np.array([1.0, 0.0], np.float32) if mode == "mixed" else 1.0
    proj = None if mode == "exact" else (jpj, tpj)

    def jf(p, xx):
        return jax_moe_block(p, xx, jcfg, local_rules, proj=None if proj is None else proj[0],
                             keep=jnp.asarray(keep), lowrank_mode=mode, recompute=True)

    (jy, jaux), vjp = jax.vjp(jf, jffn, jnp.asarray(x))
    jdp, jdx = vjp((jnp.asarray(dy), jnp.float32(1.0)))

    tp = {k: v.detach().requires_grad_() for k, v in tffn.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = moe_block(tp, tx, tcfg, proj=None if proj is None else proj[1],
                         keep=torch.from_numpy(np.asarray(keep)), lowrank_mode=mode,
                         recompute=True)
    grads = torch.autograd.grad((ty * torch.from_numpy(dy)).sum() + taux, [tx, *tp.values()])
    _close(ty, jy, "y")
    _close(taux, jaux, "aux")
    _close(grads[0], jdx, "dx", atol=1e-5)
    for (name, _), g in zip(tp.items(), grads[1:]):
        _close(g, jdp[name], f"d{name}", atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "degraded", "mixed"])
def test_lowrank_linear_grouped_grads_match_jax_vjp(mode):
    rng = np.random.default_rng(7)
    E, C, n, m, r = 4, 6, 16, 12, 3
    x = rng.standard_normal((E, C, n)).astype(np.float32)
    w = rng.standard_normal((E, n, m)).astype(np.float32)
    v1 = np.linalg.qr(rng.standard_normal((E, n, r)))[0].astype(np.float32)
    keep = (rng.random((E, C)) < 0.5).astype(np.float32)
    dy = rng.standard_normal((E, C, m)).astype(np.float32)

    jy, vjp = jax.vjp(lambda a, b: jax_llg(a, b, jnp.asarray(v1), jnp.asarray(keep), mode),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    ty = lowrank_linear_grouped(tx, tw, torch.from_numpy(v1), torch.from_numpy(keep), mode)
    tdx, tdw = torch.autograd.grad(ty, [tx, tw], torch.from_numpy(dy))
    _close(ty, jy, "y")
    _close(tdx, jdx, "dx")
    _close(tdw, jdw, "dw")
    if mode != "exact":  # the projected gradient is not the exact one
        assert not np.allclose(_np(tdw), np.einsum("ecn,ecm->enm", x, dy), atol=1e-3)


def test_refresh_projections_over_stacked_experts_match_jax():
    jcfg = jbase.reduced(jbase.get_config(NAME), dtype="float32")
    tcfg = tbase.reduced(tbase.get_config(NAME), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jproj = jax_refresh(jp, jcfg, RANK)["layers"][0]["ffn"]
    tproj = refresh_projections(tp, tcfg, RANK)["layers"][0]["ffn"]
    assert set(tproj) == set(jproj) == {"w_gate", "w_up", "w_down"}
    for k, v in jproj.items():
        assert tuple(tproj[k].shape) == v.shape == (*jp["layers"][0]["ffn"][k].shape[:-1], RANK)
        # singular vectors up to sign: compare the projectors
        a, b = _np(tproj[k]), np.asarray(v)
        _close(a @ np.swapaxes(a, -1, -2), b @ np.swapaxes(b, -1, -2), k, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu2", "gelu"])
def test_nonlin_matches_jax(act, dtype):
    u = (np.random.default_rng(11).standard_normal((64, 48)) * 3).astype(np.float32)
    ju = jnp.asarray(u, getattr(jnp, dtype))
    tu = tensor_from_numpy(np.asarray(ju), "cpu")
    jo, to = jax_nonlin(ju, act), nonlin(tu, act)
    assert to.dtype == tu.dtype
    if act == "relu2" or dtype == "bfloat16":
        # the same rounding: relu2 in the input dtype; gelu's f32 tanh form
        # rounded to bf16 (one bf16 ulp where the f32 values straddle a
        # rounding boundary)
        tol = 0 if act == "relu2" else 2 ** -7
        _close(to, jo, act, rtol=tol, atol=tol * 1e-2)
    else:  # the tanh form in f32, evaluated in other orders
        _close(to, jo, act, rtol=1e-6, atol=1e-6)
