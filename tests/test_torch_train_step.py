"""One MeCeFO training step of the port against the JAX package's, live, on
the CPU, in the four NDB modes.

Config: ``reduced(llama-350m, dtype=float32, n_kv_heads=2)`` (plain
``reduced`` keeps n_kv_heads == n_heads and would leave GQA untested) with
``MeCeFOConfig(rank=8)``; the plan ``NDBPlan(n_dp=4, n_stages=2,
failed={(1, 0)})`` degrades rank 1 on both stages (the failed stage 0 and
its neighbour stage 1), so its masks cross the stage boundary.  The JAX
state, V1 included, crosses the bridge: SVD column signs differ between the
two libraries.  The batches come from the port's ``SyntheticLM``, which is
bit-identical to the JAX one.

Tolerance rtol 1e-5 / atol 1e-6: both sides compute the same f32
arithmetic; torch's and XLA's matmuls and reductions sum in other orders,
which moves losses, gradients and moments by a few f32 ulps.  One
exception, for the params after a step with lr > 0: AdamW's update
m̂/(√v̂ + ε) does not scale with the gradient, so an element whose gradient
is as small as the summation noise of its leaf moves by up to ~lr in one
implementation and by a different amount in the other.  Params are held
at atol 1e-6 + PARAM_LR_FRAC·lr for every element, and at most
PARAM_LOOSE_SHARE of a leaf's elements may use more than 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.lowrank import refresh_projections as jax_refresh  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.state import init_state as jax_init_state  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.bridge import state_from_numpy, state_to_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.state import init_state  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PARAM_LR_FRAC, PARAM_LOOSE_SHARE = 0.1, 1e-3
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


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_match_jax(mode):
    jcfg, tcfg = _cfgs()
    tc_j = jbase.TrainConfig(learning_rate=1e-3)
    tc_t = tbase.TrainConfig(learning_rate=1e-3)
    shape_j = jbase.ShapeConfig("t", S, B, "train")
    shape_t = tbase.ShapeConfig("t", S, B, "train")
    mecefo_j = jbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    mecefo_t = tbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    keep, w = _masks(tcfg)
    mesh = make_host_mesh()
    jflags = jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16)
    with mesh:
        jst = _jax_state(jcfg, tc_j)
        jstep, *_ = jax_make_train_step(
            jcfg, tc_j, jbase.ParallelConfig(fsdp=False), mecefo_j, mesh, shape_j,
            ndb_mode=mode, static_ndb=(keep, w) if mode == "static" else None,
            total_steps=10, flags=jflags, donate=False)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    tstep = make_train_step(tcfg, tc_t, mecefo_t, shape_t, ndb_mode=mode,
                            static_ndb=(keep, w) if mode == "static" else None,
                            total_steps=10, flags=ExecFlags(remat="ffn", ce_chunk=16),
                            device="cpu")
    src = SyntheticLM(tcfg.vocab_size)
    ndb = {"keep": keep, "example_weight": w}
    for i in range(4):  # step 0 runs at lr 0 (warmup), steps 1-3 move the params
        batch = src.batch(i, B, S)
        with mesh:
            if mode == "dynamic":
                jst, jm = jstep(jst, batch, jax.tree.map(jnp.asarray, ndb))
            else:
                jst, jm = jstep(jst, batch)
        tst, tm = tstep(tst, batch, ndb) if mode == "dynamic" else tstep(tst, batch)
        assert tst.step == int(jst.step) == i + 1
        _close(tm["loss"], jm["loss"], f"step {i} loss")
        _close(tm["grad_norm"], jm["grad_norm"], f"step {i} grad_norm")
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6, abs=1e-12)
        got, ref = state_to_numpy(tst), jax.tree.map(np.asarray, jst)
        for j, (x, y) in enumerate(zip(tree_leaves(got.params), jax.tree.leaves(ref.params))):
            _close(x, y, f"step {i} params leaf {j}", atol=ATOL + PARAM_LR_FRAC * tm["lr"])
            loose = np.abs(x - y) > ATOL + RTOL * np.abs(y)
            assert loose.mean() <= PARAM_LOOSE_SHARE, f"step {i} params leaf {j}: {loose.mean()}"
        for what, a, b in (("m", got.opt.m, ref.opt.m), ("v", got.opt.v, ref.opt.v),
                           ("proj", got.proj, ref.proj)):
            for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
                _close(x, y, f"step {i} {what} leaf {j}")


def test_step_refuses_what_it_does_not_port():
    _, tcfg = _cfgs()
    tc, mecefo = tbase.TrainConfig(), tbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    shape = tbase.ShapeConfig("t", S, B, "train")

    with pytest.raises(ValueError):
        make_train_step(tcfg, tc, mecefo, shape, ndb_mode="static", device="cpu")
    state = init_state(tcfg, tc, mecefo, torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticLM(tcfg.vocab_size).batch(0, B, S)
    with pytest.raises(ValueError, match="ndb"):
        make_train_step(tcfg, tc, mecefo, shape, ndb_mode="dynamic", device="cpu")(state, batch)
    short = {k: v[:, :16] for k, v in batch.items()}
    with pytest.raises(ValueError, match="want"):
        make_train_step(tcfg, tc, mecefo, shape, device="cpu")(state, short)


def test_remat_full_and_none_give_the_same_step():
    _, tcfg = _cfgs()
    tc, mecefo = tbase.TrainConfig(learning_rate=1e-3), tbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    shape = tbase.ShapeConfig("t", S, B, "train")
    keep, w = _masks(tcfg)
    batch = SyntheticLM(tcfg.vocab_size).batch(1, B, S)
    out = {}
    for remat in ("none", "ffn", "full"):
        state = init_state(tcfg, tc, mecefo, torch.Generator().manual_seed(0), device="cpu")
        step = make_train_step(tcfg, tc, mecefo, shape, ndb_mode="dynamic", total_steps=10,
                               flags=ExecFlags(remat=remat, ce_chunk=16), device="cpu")
        for _ in range(2):
            state, m = step(state, batch, {"keep": keep, "example_weight": w})
        out[remat] = (float(m["loss"]), tree_leaves(state.params))
    for remat in ("ffn", "full"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
