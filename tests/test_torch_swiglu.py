"""Kernel #4's two arithmetics and its backward against the JAX package,
live, on the CPU (the plain versions; the kernels' card checks are in
``tests/test_torch_cuda.py``).

* ``round_silu=True`` (the JAX trunk's ``silu(g.astype(f32)).astype(u.dtype)
  * u``, ``models/layers.py`` ffn_block, ``models/moe.py`` experts): the
  forward bitwise the trunk expression's in bf16; its gradients against
  ``jax.vjp`` of that expression: du bitwise, dg within one bf16 ulp in
  fewer than 1 in 10,000 elements (silu' in f32 is PyTorch's
  ``silu_backward`` form, JAX differentiates ``x * sigmoid(x)``).  At f32
  everything within 1e-6 of the largest magnitude (the two silu formulas
  differ in the last f32 bits).
* The model path: the port's FFN sublayer bitwise the JAX sublayer's, and
  ``moe.experts`` bitwise the trunk expression, in bf16 with identity
  weights (every product exact on both sides), so the only rounding left
  is the activation's.
* ``swiglu_bwd_plain`` and ``SwiGLUFn`` in both arithmetics against torch
  autograd of ``swiglu_plain``: bitwise (the same torch operations), and
  zero-width inputs (mamba2's ``d_ff = 0``), which launch nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models.layers import ffn_block as jax_ffn_block  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import swiglu as sg  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import ffn_block  # noqa: E402

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
F32_REL = 1e-6       # f32: of the largest magnitude
DG_ULP_SHARE = 1e-4  # bf16 dg: share of elements allowed one ulp apart


def _trunk(g, u):
    """The JAX trunk's activation, as ``repro/models/layers.py:330`` writes it."""
    return jax.nn.silu(g.astype(jnp.float32)).astype(u.dtype) * u


def _inputs(seed, shape, dtype):
    """g ~ 3 N(0, 1) (silu's curved part and both tails), u and dy ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    g = (3 * rng.standard_normal(shape)).astype(np.float32)
    u, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in (g, u, dy)],
            [jnp.asarray(a).astype(jdt) for a in (g, u, dy)])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed,shape", [(0, (1024, 768)), (1, (1024, 768)), (2, (3, 5, 37))])
def test_trunk_arithmetic_matches_jax_trunk_and_its_vjp(seed, shape, dtype):
    (g, u, dy), (gj, uj, dyj) = _inputs(seed, shape, dtype)
    yj, vjp = jax.vjp(_trunk, gj, uj)
    dgj, duj = (_np(a) for a in vjp(dyj))
    y = _np(sg.swiglu_plain(g, u, round_silu=True))
    dg, du = (_np(a) for a in sg.swiglu_bwd_plain(g, u, dy, round_silu=True))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(y, _np(yj))
        np.testing.assert_array_equal(du, duj)
        apart = dg != dgj
        assert apart.sum() < DG_ULP_SHARE * dg.size, apart.sum()
        assert (np.abs(dg - dgj) <= _bf16_ulp(dgj))[apart].all()
    else:
        for got, want in ((y, _np(yj)), (du, duj), (dg, dgj)):
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * np.abs(want).max())


def test_the_two_arithmetics_differ_in_bf16_and_agree_at_f32():
    """What the repair changes: the Pallas kernel's single rounding moves
    about a quarter of the bf16 outputs off the trunk's; at f32 the two
    arithmetics are one function."""
    (g, u, _), _ = _inputs(0, (1024, 768), "bfloat16")
    apart = (sg.swiglu_plain(g, u) != sg.swiglu_plain(g, u, round_silu=True)).float().mean()
    assert 0.2 < float(apart) < 0.35
    (g, u, dy), _ = _inputs(0, (64, 96), "float32")
    assert torch.equal(sg.swiglu_plain(g, u), sg.swiglu_plain(g, u, round_silu=True))
    for a, b in zip(sg.swiglu_bwd_plain(g, u, dy), sg.swiglu_bwd_plain(g, u, dy, True)):
        assert torch.equal(a, b)


def _identity_ffn(d, f, dtype):
    eye = torch.eye(d, f, dtype=dtype)
    return {"ln": torch.ones(d, dtype=dtype), "w_gate": eye, "w_up": eye.clone(),
            "w_down": torch.eye(f, d, dtype=dtype)}


def test_ffn_sublayer_takes_the_trunk_activation_in_bf16(local_rules):
    """The port's FFN sublayer against the JAX one with identity weights and
    a unit norm scale: the products are exact, the norms agree bitwise here
    (checked), so the outputs are bitwise equal only if the activation
    rounds as the trunk does."""
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="bfloat16")
    tcfg = reduced(get_config("qwen3-0.6b"), dtype="bfloat16")
    d = tcfg.d_model
    jcfg, tcfg = (dataclasses.replace(c, d_ff=d) for c in (jcfg, tcfg))
    x = (3 * np.random.default_rng(0).standard_normal((4, 64, d))).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    tp = _identity_ffn(d, d, torch.bfloat16)
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in tp.items()}
    np.testing.assert_array_equal(_np(rmsnorm_plain(xt, tp["ln"], tcfg.norm_eps)),
                                  _np(jax_rmsnorm(xj, jp["ln"], jcfg.norm_eps)))
    np.testing.assert_array_equal(_np(ffn_block(tp, xt, tcfg)),
                                  _np(jax_ffn_block(jp, xj, jcfg, local_rules)))


def test_moe_experts_take_the_trunk_activation_in_bf16():
    """``moe.experts`` over an (E, C, d) buffer with identity expert weights
    is the trunk expression of the buffer with itself, bitwise."""
    tcfg = reduced(get_config("qwen3-moe-30b-a3b"), dtype="bfloat16")
    E, C, d = 4, 96, tcfg.d_model
    ffn = _identity_ffn(d, d, torch.bfloat16)
    p = {k: ffn[k].expand(E, d, d).contiguous() for k in ("w_gate", "w_up", "w_down")}
    xb = (3 * np.random.default_rng(1).standard_normal((E, C, d))).astype(np.float32)
    xt = torch.from_numpy(xb).to(torch.bfloat16)
    xj = jnp.asarray(xb).astype(jnp.bfloat16)
    y = moe.experts(p, xt, torch.ones(E, C, dtype=torch.bfloat16), tcfg)
    np.testing.assert_array_equal(_np(y), _np(_trunk(xj, xj)))


@pytest.mark.parametrize("round_silu", [False, True], ids=["pallas", "trunk"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_plain_and_function_match_torch_autograd(dtype, round_silu):
    (g, u, dy), _ = _inputs(3, (37, 100), dtype)
    a = [t.clone().requires_grad_() for t in (g, u)]
    ya = sg.swiglu_plain(*a, round_silu)
    want = torch.autograd.grad(ya, a, dy)
    for got in (sg.swiglu_bwd_plain(g, u, dy, round_silu), sg.swiglu_bwd(g, u, dy, round_silu)):
        for x, w in zip(got, want):
            assert x.dtype == w.dtype and torch.equal(x, w)
    b = [t.clone().requires_grad_() for t in (g, u)]
    yb = sg.SwiGLUFn.apply(*b, round_silu)
    assert yb.grad_fn is not None and torch.equal(yb, ya)
    for x, w in zip(torch.autograd.grad(yb, b, dy), want):
        assert torch.equal(x, w)


@pytest.mark.parametrize("round_silu", [False, True], ids=["pallas", "trunk"])
def test_zero_width_launches_nothing(round_silu):
    z = torch.zeros(64, 0, dtype=torch.bfloat16)
    before = (sg.swiglu.launches, sg.swiglu_bwd.launches)
    assert sg.swiglu_launch(z, z, round_silu=round_silu).shape == (64, 0)
    assert [t.shape for t in sg.swiglu_bwd_launch(z, z, z, round_silu=round_silu)] == [(64, 0)] * 2
    assert sg.swiglu(z, z, round_silu=round_silu).shape == (64, 0)
    zg = z.clone().requires_grad_()
    y = sg.SwiGLUFn.apply(zg, z, round_silu)
    (dg,) = torch.autograd.grad(y, [zg], torch.zeros_like(y))
    assert dg.shape == (64, 0)
    assert (sg.swiglu.launches, sg.swiglu_bwd.launches) == before


@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_launch_refuses_operands_the_kernel_lacks(bwd):
    # each refusal comes before a launch, so it shows on CPU tensors
    x = torch.zeros(4, 8)
    for g, u, match in ((x, torch.zeros(4, 9), "differ"), (x, x.bfloat16(), "dtype"),
                        (x.t(), x.t(), "contiguous"), (x.half(), x.half(), "not supported")):
        with pytest.raises(ValueError, match=match):
            if bwd:
                sg.swiglu_bwd_launch(g, u, u)
            else:
                sg.swiglu_launch(g, u)
