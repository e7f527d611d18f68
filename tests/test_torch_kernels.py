"""The port's kernel modules against the JAX Pallas kernels, on the CPU.

Here every wrapper runs its plain version (the tensors lie on the CPU); the
same numpy inputs go through the JAX Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, and through ``repro/kernels/ref.py``.
Shapes include odd row and column counts.  Tolerances follow
``tests/test_kernels.py``: attention 2e-5 (f32) / 2e-2 (bf16), decode 2e-5
/ 3e-2, rmsnorm 1e-5 (f32; bf16 2e-2, one bf16 ulp at the normalized
values' magnitude), swiglu 1e-6 (f32, with a 1e-6 relative term for the
larger products) / 2e-2 (bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.paged_decode import paged_flash_decode as jax_paged  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.swiglu import swiglu as jax_swiglu  # noqa: E402

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_attention_heads, flash_attention, flash_attention_plain, rounding_ratio,
)
from repro_torch.kernels.flash_decode import check_decode_heads  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.swiglu import swiglu, swiglu_plain  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _pair(a32: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a32, jnp.dtype(dtype))
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 96), (3, 5, 128), (7, 1024),
                                   # the decode round's rows: sublayer and final
                                   # norms, q_norm, k_norm; and a 4096-wide row
                                   (8, 1024), (128, 128), (64, 128), (3, 4096)])
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    xj, xt = _pair(rng.standard_normal(shape), dtype)
    sj, st = _pair(rng.standard_normal(shape[-1]), dtype)
    out = rmsnorm(xt, st, 1e-5)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    pallas = jax_rmsnorm(xj, sj, 1e-5, block_rows=8, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(out), _np(ref.rmsnorm_ref(xj, sj, 1e-5)), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 100), (5, 3, 384)])
def test_swiglu_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(sum(shape) + 1)
    gj, gt = _pair(rng.standard_normal(shape), dtype)
    uj, ut = _pair(rng.standard_normal(shape), dtype)
    out = swiglu(gt, ut)
    assert out.dtype == gt.dtype and out.shape == gt.shape
    atol, rtol = (1e-6, 1e-6) if dtype == "float32" else (2e-2, 0)
    pallas = jax_swiglu(gj, uj, block_rows=8, block_cols=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(out), _np(ref.swiglu_ref(gj, uj)), atol=atol, rtol=rtol)


FLASH_CASES = [
    # (B, S, H, KV, hd, block) — JAX needs S % block == 0
    (2, 48, 4, 2, 32, 16),
    (1, 40, 4, 1, 64, 8),
    # the configs' head widths 96 (phi-3-vision) and 192 (nemotron-4-340b),
    # and groups of 16 (glm4-9b) and 48 (granite-34b)
    (1, 32, 2, 2, 96, 16),
    (1, 24, 4, 2, 192, 8),
    (1, 16, 16, 1, 32, 8),
    (1, 16, 48, 1, 32, 8),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_pallas_and_ref(case, dtype):
    B, S, H, KV, hd, blk = case
    rng = np.random.default_rng(S + hd)
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
    out = flash_attention(qt, kt, vt)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    pallas = jax_flash(qj, kj, vj, block_q=blk, block_k=blk, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(out), _np(ref.flash_attention_ref(qj, kj, vj)),
                               atol=tol, rtol=0)


ROUND_CASES = [
    # (B, S, H, KV, hd, block): causal GQA with S not a multiple of the CUDA
    # kernel's 64-row tiles (JAX needs S % block == 0)
    (1, 72, 4, 4, 64, 24),
    (1, 100, 4, 2, 128, 20),
    (1, 80, 4, 4, 96, 20),
    (1, 70, 4, 2, 192, 14),
]


@pytest.mark.parametrize("case", ROUND_CASES)
def test_flash_attention_split_p_within_rounding_limit_of_pallas(case):
    """The bf16 kernel's precision scheme, emulated in plain torch (P split
    into bf16 P_hi + P_lo, f32 products and sums, one cast), against the
    Pallas kernel in interpret mode on the inputs cast to f32: every output
    within half a bf16 ulp plus the stated slack (the card's rounding row).
    The control rounds P once to bf16 and must fall outside."""
    B, S, H, KV, hd, blk = case
    rng = np.random.default_rng(S + hd + 1)
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)), "bfloat16")
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), "bfloat16")
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), "bfloat16")
    f32 = [a.astype(jnp.float32) for a in (qj, kj, vj)]
    y = _np(jax_flash(*f32, block_q=blk, block_k=blk, interpret=True))
    mag = _np(jax_flash(f32[0], f32[1], jnp.abs(f32[2]), block_q=blk, block_k=blk,
                        interpret=True))
    y, mag = torch.from_numpy(y), torch.from_numpy(mag)
    split = flash_attention_plain(qt, kt, vt, p_precision="split")
    assert split.dtype == torch.bfloat16
    assert float(rounding_ratio(split, y, mag).max()) <= 1.0
    control = rounding_ratio(flash_attention_plain(qt, kt, vt, p_precision="bf16"), y, mag)
    assert float(control.max()) > 2.0 and int((control > 1).sum()) > 0.01 * control.numel()


def _paged_case(dtype, seed=0, B=3, H=4, KV=2, hd=32, ps=4, P=5, n_pages=17):
    rng = np.random.default_rng(seed)
    lens = np.array([0, 7, 20][:B], np.int32)
    tables = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for b in range(B):
        tables[b, :-(-int(lens[b]) // ps)] = perm[b * P:b * P + (-(-int(lens[b]) // ps))]
    q = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    k = _pair(rng.standard_normal((n_pages, ps, KV, hd)), dtype)
    v = _pair(rng.standard_normal((n_pages, ps, KV, hd)), dtype)
    return q, k, v, tables, lens


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_paged_decode_matches_pallas_and_ref(dtype, seed):
    (qj, qt), (kj, kt), (vj, vt), tables, lens = _paged_case(dtype, seed)
    out = paged_decode(qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(lens))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    pallas = jax_paged(qj, kj, vj, jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=0)
    for b in np.nonzero(lens)[0]:  # the dense oracle per live lane
        kd = kj[jnp.asarray(tables[b])].reshape(1, -1, *kj.shape[2:])
        vd = vj[jnp.asarray(tables[b])].reshape(1, -1, *vj.shape[2:])
        want = ref.flash_decode_ref(qj[b:b + 1], kd, vd, int(lens[b]))
        np.testing.assert_allclose(_np(out)[b:b + 1], _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_plain_layout_invariant_and_null_lanes_zero(dtype):
    """The same logical KV in another physical page layout gives bitwise the
    same output; a length-0 lane outputs exactly 0."""
    (_, qt), (_, kt), (_, vt), tables, lens = _paged_case(dtype, seed=3, n_pages=40)
    out = paged_decode_plain(qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(lens))
    rng = np.random.default_rng(11)
    new_ids = rng.permutation(np.arange(1, 40))  # old page p -> new page new_ids[p-1]
    k2, v2 = torch.zeros_like(kt), torch.zeros_like(vt)
    tables2 = np.zeros_like(tables)
    for b in range(tables.shape[0]):
        for i in range(-(-int(lens[b]) // 4)):
            old, new = int(tables[b, i]), int(new_ids[int(tables[b, i]) - 1])
            k2[new], v2[new] = kt[old], vt[old]
            tables2[b, i] = new
    out2 = paged_decode_plain(qt, k2, v2, torch.from_numpy(tables2), torch.from_numpy(lens))
    assert torch.equal(out, out2)
    assert torch.equal(out[lens == 0], torch.zeros_like(out[lens == 0]))
    assert torch.isfinite(out.float()).all()


def test_wrappers_take_the_plain_version_on_cpu_and_do_not_count():
    before = (rmsnorm.launches, swiglu.launches, flash_attention.launches,
              paged_decode.launches)
    x = torch.randn(4, 32)
    assert torch.equal(rmsnorm(x, torch.ones(32)), rmsnorm_plain(x, torch.ones(32)))
    assert torch.equal(swiglu(x, x), swiglu_plain(x, x))
    q = torch.randn(1, 8, 2, 32)
    assert torch.equal(flash_attention(q, q, q), flash_attention_plain(q, q, q))
    after = (rmsnorm.launches, swiglu.launches, flash_attention.launches,
             paged_decode.launches)
    assert before == after


def test_wrappers_raise_on_other_devices():
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        rmsnorm(x, torch.empty(32, device="meta"))
    with pytest.raises(ValueError, match="devices"):
        swiglu(x, torch.randn(4, 32))


def test_plain_versions_switch_nests_restores_and_keeps_the_device_check():
    from repro_torch import kernels

    x = torch.empty(4, 32, device="meta")
    assert not kernels._PLAIN
    with kernels.plain_versions():
        with kernels.plain_versions():
            assert kernels.runs_plain(torch.randn(3))
        assert kernels._PLAIN
        with pytest.raises(ValueError, match="devices"):
            kernels.runs_plain(x)
    assert not kernels._PLAIN
    with pytest.raises(RuntimeError, match="inside"):
        with kernels.plain_versions():
            raise RuntimeError("inside")
    assert not kernels._PLAIN


# the repo's configs whose attention heads need sub-groups or the head
# widths 96 and 192: (H / KV, hd) = 32/2 x 128, 64/4 x 128, 48/1 x 128,
# 96/8 x 192, 32/32 x 96
HEAD_CONFIGS = ["glm4-9b", "qwen3-moe-235b-a22b", "granite-34b", "nemotron-4-340b",
                "phi-3-vision-4.2b"]


@pytest.mark.parametrize("name", HEAD_CONFIGS)
def test_attention_wrappers_take_the_configs_head_shapes(name):
    """The decode (#1, #5) and prefill (#2) wrappers' head checks pass each
    config's heads."""
    cfg = jax_get_config(name)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    check_decode_heads(torch.empty(1, 1, H, hd), KV)
    check_attention_heads(H, KV, hd)


@pytest.mark.parametrize("heads", [(32, 3, 128), (6, 4, 96), (4, 0, 64)])
def test_attention_wrappers_refuse_heads_not_a_multiple_of_kv(heads):
    H, KV, hd = heads
    with pytest.raises(ValueError, match="multiple"):
        check_decode_heads(torch.empty(1, 1, H, hd), KV)
    with pytest.raises(ValueError, match="multiple"):
        check_attention_heads(H, KV, hd)


@pytest.mark.parametrize("hd", [48, 80, 256])
def test_attention_wrappers_refuse_head_dims_not_built(hd):
    with pytest.raises(ValueError, match="head_dim"):
        check_decode_heads(torch.empty(1, 1, 4, hd), 2)
    with pytest.raises(ValueError, match="head_dim"):
        check_attention_heads(4, 2, hd)
