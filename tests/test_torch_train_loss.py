"""The port's training loss and gradients against the JAX package's
``forward_loss`` under ``jax.value_and_grad``, live, on the CPU, in the four
NDB modes, with and without a padded vocabulary.

Config, plan and tolerances as in ``tests/test_torch_train_step.py``:
``reduced(llama-350m, dtype=float32, n_kv_heads=2)``, ``MeCeFOConfig(rank=8)``,
``NDBPlan(n_dp=4, n_stages=2, failed={(1, 0)})``; the JAX state, V1
included, crosses the bridge.  rtol 1e-5 / atol 1e-6: the same f32
arithmetic, summed in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import refresh_projections as jax_refresh  # noqa: E402
from repro.core.ndb import NDBContext as JaxContext  # noqa: E402
from repro.launch.state import init_state as jax_init_state  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.bridge import state_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MODES = ["off", "dynamic", "static", "degraded"]
B, S, RANK = 8, 32, 8
PLAN = NDBPlan(n_dp=4, n_stages=2, failed=frozenset({(1, 0)}))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _close(a, b, what, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=atol, err_msg=what)


def _cfgs(**kw):
    return (jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2, **kw),
            tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2, **kw))


def _jax_state(jcfg, tc):
    st = jax_init_state(jcfg, tc, jbase.MeCeFOConfig(mode="dynamic", rank=RANK),
                        jax.random.PRNGKey(0))
    return st._replace(proj=jax_refresh(st.params, jcfg, RANK))


def _masks(cfg):
    keep, w = plan_to_masks(PLAN, cfg, B)
    assert 0 < keep.mean() < 1 and (keep[0] == keep[-1]).all()
    return keep, w


@pytest.mark.parametrize("vocab", [None, 500], ids=["v512", "v500-padded"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_loss_and_grads_match_jax(mode, vocab, local_rules):
    jcfg, tcfg = _cfgs(**({"vocab_size": vocab} if vocab else {}))
    jst = _jax_state(jcfg, jbase.TrainConfig())
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    batch = SyntheticLM(tcfg.vocab_size).batch(0, B, S)
    keep, w = _masks(tcfg)
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

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jst.params)
    tl, tm, tg = loss_and_grads(tst.params, tst.proj, {k: torch.from_numpy(v) for k, v in batch.items()},
                                tcfg, tctx, ExecFlags(remat="ffn", ce_chunk=16))
    _close(tl, jl, "loss")
    _close(tm["ce"], jm["ce"], "ce")
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert tuple(a.shape) == b.shape
        _close(a, b, f"grad leaf {i} {b.shape}")
    if mode == "degraded":  # technique I: no MHA weight gradient at all
        assert not any(g.any() for g in tg["layers"][0]["mixer"].values())
    if vocab:  # pad rows of the unembedding take no gradient
        assert not tg["unembed"][:, vocab:].any()
