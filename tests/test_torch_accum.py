"""Gradient accumulation and the dot-saving remat of the port's training
step against the JAX package's, live, on the CPU.

* ``make_train_step`` with ``accum`` 2 and 4 in the four NDB modes, with
  and without bf16 ``grad_compression``, against the JAX step on
  ``make_host_mesh()``: three steps' loss, ``ce``, ``aux``, grad norm, lr,
  params and AdamW moments (the first moment after a step is the clipped
  gradient times 1 - b1, so it holds the gradients); the fallback to one
  micro-batch where the batch does not divide;
* ``remat="dots"``: the loss and every gradient leaf equal ``"none"``'s,
  and the remat keeps the period's matrix products.

Config, plan and tolerances as in ``tests/test_torch_train_step.py``
(``reduced(llama-350m, dtype=float32, n_kv_heads=2)``, rank 8, rtol 1e-5 /
atol 1e-6, params at atol 1e-6 + PARAM_LR_FRAC·lr).  With bf16
compression each micro-gradient is rounded to bf16 on both sides: an
element that lands within summation noise of a rounding boundary rounds
one bf16 ulp (2^-8 of the micro-gradient) apart, and where the
micro-gradients cancel that is a larger share of their mean: there the
moments are held within 2^-7 of the leaf's largest element, and the
moments and params off by more than rtol 1e-5 / atol 1e-6 may be at most
BF16_FLIP_SHARE of a leaf's elements.
"""
import functools

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
from repro_torch.core.ndb import NDBContext, NDBPlan, plan_to_masks  # noqa: E402
from repro_torch.core.recompute import dots_recompute  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PARAM_LR_FRAC, PARAM_LOOSE_SHARE = 0.1, 1e-3
BF16_FLIP_SHARE = 1e-2
MODES = ["off", "dynamic", "static", "degraded"]
B, S, RANK = 8, 32, 8
PLAN = NDBPlan(n_dp=4, n_stages=2, failed=frozenset({(1, 0)}))


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


def _close(a, b, what, atol=ATOL, flips=False):
    a, b = _np(a), _np(b)
    if not flips:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)
        return
    loose = np.abs(a - b) > atol + RTOL * np.abs(b)
    assert loose.mean() <= BF16_FLIP_SHARE, f"{what}: {loose.mean()}"
    np.testing.assert_allclose(a, b, rtol=0, atol=atol + 2.0 ** -7 * float(np.abs(b).max()),
                               err_msg=what)


def _cfgs():
    return (jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2),
            tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2))


@functools.lru_cache(maxsize=1)
def _jax_state():
    """The seeded JAX TrainState with V1, shared by every case (the JAX
    step does not donate it)."""
    jcfg, _ = _cfgs()
    jst = jax_init_state(jcfg, jbase.TrainConfig(learning_rate=1e-3),
                         jbase.MeCeFOConfig(mode="dynamic", rank=RANK), jax.random.PRNGKey(0))
    return jst._replace(proj=jax_refresh(jst.params, jcfg, RANK))


def _run(mode, accum, compression, steps=3):
    """``steps`` steps of both packages from the JAX state; yields (step,
    port metrics, JAX metrics, port state, JAX state) after each."""
    jcfg, tcfg = _cfgs()
    shape = ("t", S, B, "train")
    keep, w = plan_to_masks(PLAN, tcfg, B)
    mesh = make_host_mesh()
    static = (keep, w) if mode == "static" else None
    with mesh:
        jstep, sshard, *_ = jax_make_train_step(
            jcfg, jbase.TrainConfig(learning_rate=1e-3),
            jbase.ParallelConfig(fsdp=False, accum=accum, grad_compression=compression),
            jbase.MeCeFOConfig(mode="dynamic", rank=RANK), mesh, jbase.ShapeConfig(*shape),
            ndb_mode=mode, static_ndb=static, total_steps=10,
            flags=jmodel.ExecFlags(remat="ffn", attn_chunk=S, ce_chunk=16), donate=False)
        # on the step's own shardings, so its first call compiles the
        # program its later calls run
        jst = jax.device_put(_jax_state(), sshard)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, device="cpu")
    tstep = make_train_step(
        tcfg, tbase.TrainConfig(learning_rate=1e-3), tbase.MeCeFOConfig(mode="dynamic", rank=RANK),
        tbase.ShapeConfig(*shape), ndb_mode=mode, static_ndb=static, total_steps=10,
        flags=ExecFlags(remat="ffn", ce_chunk=16), device="cpu",
        parallel=tbase.ParallelConfig(accum=accum, grad_compression=compression))
    src = SyntheticLM(tcfg.vocab_size)
    ndb = {"keep": keep, "example_weight": w}
    for i in range(steps):
        batch = src.batch(i, B, S)
        extra = (ndb,) if mode == "dynamic" else ()
        with mesh:
            jst, jm = jstep(jst, batch, *(jax.tree.map(jnp.asarray, e) for e in extra))
        tst, tm = tstep(tst, batch, *extra)
        yield i, tm, jm, tst, jst


def _check(mode, accum, compression):
    flips = compression == "bf16"
    for i, tm, jm, tst, jst in _run(mode, accum, compression):
        for k in ("loss", "ce", "aux"):
            _close(tm[k], jm[k], f"step {i} {k}")
        _close(tm["grad_norm"], jm["grad_norm"], f"step {i} grad_norm",
               atol=1e-4 if flips else ATOL)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6, abs=1e-12)
        got, ref = state_to_numpy(tst), jax.tree.map(np.asarray, jst)
        for j, (x, y) in enumerate(zip(tree_leaves(got.params), jax.tree.leaves(ref.params))):
            x, y = _np(x), _np(y)
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL + PARAM_LR_FRAC * tm["lr"],
                                       err_msg=f"step {i} params leaf {j}")
            loose = np.abs(x - y) > ATOL + RTOL * np.abs(y)
            share = BF16_FLIP_SHARE if flips else PARAM_LOOSE_SHARE
            assert loose.mean() <= share, f"step {i} params leaf {j}: {loose.mean()}"
        for what, a, b in (("m", got.opt.m, ref.opt.m), ("v", got.opt.v, ref.opt.v)):
            for j, (x, y) in enumerate(zip(tree_leaves(a), jax.tree.leaves(b))):
                _close(x, y, f"step {i} {what} leaf {j}", flips=flips)


@pytest.mark.parametrize("compression", ["none", "bf16"])
@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_accumulated_steps_match_jax(mode, accum, compression):
    _check(mode, accum, compression)


def test_indivisible_batch_falls_back_to_one_micro_batch():
    """B 8 with accum 3: both packages take one micro-batch, so the step
    equals the unaccumulated one."""
    _check("dynamic", 3, "none")
    *_, (_, one, _, _, _) = _run("dynamic", 1, "none", steps=1)
    *_, (_, three, _, _, _) = _run("dynamic", 3, "none", steps=1)
    assert float(one["loss"]) == float(three["loss"])


@pytest.mark.parametrize("mode", MODES)
def test_dots_remat_gradients_equal_no_remat(mode):
    _, tcfg = _cfgs()
    tst = state_from_numpy(jax.tree.map(np.asarray, _jax_state()), tcfg, device="cpu")
    keep, w = plan_to_masks(PLAN, tcfg, B)
    masked = mode in ("dynamic", "static")
    ctx = NDBContext(mode=mode, keep=torch.from_numpy(keep) if masked else None,
                     example_weight=torch.from_numpy(w) if masked else None,
                     mecefo=tbase.MeCeFOConfig(mode="dynamic", rank=RANK))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(tcfg.vocab_size).batch(0, B, S).items()}
    out = {}
    for remat in ("none", "dots"):
        out[remat] = loss_and_grads(tst.params, tst.proj, batch, tcfg, ctx,
                                    ExecFlags(remat=remat, ce_chunk=16))
    assert float(out["dots"][0]) == float(out["none"][0])
    for a, b in zip(tree_leaves(out["dots"][2]), tree_leaves(out["none"][2])):
        _close(a, b, "dots vs none gradient")


def test_dots_remat_saves_matrix_products_only():
    """The policy keeps ``mm`` outputs (no batch dimension) and recomputes
    the rest; the gradients equal the plain function's."""
    w = torch.randn(6, 6, requires_grad=True)
    x = torch.randn(4, 6, requires_grad=True)

    def fn(x, w):
        return torch.tanh(x @ w) @ w

    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = dots_recompute(fn)(x, w)
    got = torch.autograd.grad(y.square().sum(), [x, w])
    want = torch.autograd.grad(fn(x, w).square().sum(), [x, w])
    assert all(torch.allclose(a, b, rtol=1e-6, atol=0) for a, b in zip(got, want))
    assert len(saved) == 2  # the checkpoint's inputs; the products sit in its cache
    assert dots_recompute(fn)(x.detach(), w.detach()).grad_fn is None
