"""Kernel #5's module (dense flash decode) and the attention functions around
it, against the JAX package, live, on the CPU.

On the CPU ``flash_decode`` runs its plain version.  The same numpy inputs
go through the JAX Pallas kernel (``ops.flash_decode`` in interpret mode,
which pads ``Smax`` up to a block multiple where the port's kernel masks
the ragged last block), through ``repro/kernels/ref.py:flash_decode_ref``
(scalar lengths; per row for ragged ones) and through the JAX model's
``decode_attention`` and ``history_attention``.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32 and 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels.ref import flash_decode_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    cur_len_vector, flash_decode, flash_decode_plain,
)
from repro_torch.kernels.paged_decode import paged_decode_plain  # noqa: E402
from repro_torch.models.layers import decode_attention, history_attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

CASES = [
    # (B, Smax, H, KV, hd, cur_len, block_k): G = H // KV
    (2, 64, 4, 4, 32, 40, 16),                  # G 1, scalar length
    (3, 50, 4, 2, 64, [0, 17, 50], 16),         # G 2, ragged Smax, a length-0 lane
    (2, 72, 8, 2, 128, [33, 72], 32),           # G 4, hd 128, ragged last block
    (4, 40, 4, 2, 32, [1, 16, 17, 39], 16),     # block edges, Smax % bk != 0
    (1, 30, 4, 1, 64, 30, 64),                  # block_k > Smax (one block)
]


def _pair(a32: np.ndarray, dtype: str):
    j = jnp.asarray(a32, jnp.dtype(dtype))
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _case(case, dtype, seed):
    B, Smax, H, KV, hd, cur_len, bk = case
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    k = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    v = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    lens = np.broadcast_to(np.asarray(cur_len, np.int32), (B,)).copy()
    return q, k, v, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-S{}-H{}-KV{}-hd{}".format(*c[:5]))
def test_flash_decode_plain_matches_pallas_and_ref(case, dtype):
    (qj, qt), (kj, kt), (vj, vt), lens = _case(case, dtype, seed=case[1] + case[4])
    cur_len, bk = case[5], case[6]
    scalar = np.ndim(cur_len) == 0
    t_len = int(cur_len) if scalar else torch.from_numpy(lens)
    out = flash_decode(qt, kt, vt, t_len, block_k=bk)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert torch.equal(out, flash_decode_plain(qt, kt, vt, t_len))
    tol = TOL[dtype]
    j_len = jnp.int32(cur_len) if scalar else jnp.asarray(lens)
    pallas = ops.flash_decode(qj, kj, vj, j_len, block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=0)
    for b in range(len(lens)):
        if lens[b] == 0:  # the clamped denominator: exactly 0 (the ref averages V)
            assert torch.equal(out[b], torch.zeros_like(out[b]))
            continue
        want = flash_decode_ref(qj[b:b + 1], kj[b:b + 1], vj[b:b + 1], int(lens[b]))
        np.testing.assert_allclose(_np(out)[b:b + 1], _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("cur_len", [5, np.int32(5), "tensor0d", "tensorB"])
def test_cur_len_forms_agree(cur_len):
    (_, qt), (_, kt), (_, vt), _ = _case(CASES[0], "float32", seed=1)
    if cur_len == "tensor0d":
        cur_len = torch.tensor(5, dtype=torch.int32)
    elif cur_len == "tensorB":
        cur_len = torch.tensor([5, 5], dtype=torch.int32)
    assert cur_len_vector(cur_len, 2, "cpu").tolist() == [5, 5]
    assert torch.equal(flash_decode_plain(qt, kt, vt, cur_len), flash_decode_plain(qt, kt, vt, 5))


def test_paged_plain_is_dense_plain_over_the_gathered_view():
    """Kernel #1's plain version over shuffled pages equals kernel #5's over
    the dense view gathered from them, bitwise (the CPU side of the card's
    bitwise #1 == #5 row)."""
    rng = np.random.default_rng(4)
    B, H, KV, hd, ps, P = 3, 4, 2, 32, 4, 5
    n_pages = 1 + B * P
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((n_pages, ps, KV, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pages, ps, KV, hd)).astype(np.float32))
    tables = torch.from_numpy((rng.permutation(n_pages - 1)[:B * P] + 1).reshape(B, P)
                              .astype(np.int32))
    lens = torch.tensor([0, 9, 20], dtype=torch.int32)
    kd = kp[tables.long()].reshape(B, P * ps, KV, hd)
    vd = vp[tables.long()].reshape(B, P * ps, KV, hd)
    assert torch.equal(paged_decode_plain(q, kp, vp, tables, lens),
                       flash_decode(q, kd, vd, lens, block_k=ps))


@pytest.mark.parametrize("lens", [[5, 33, 64], 40])
def test_decode_attention_matches_jax_model(lens):
    """The port's ``decode_attention`` (kernel #5's function) against the
    JAX model's jnp ``decode_attention`` at f32 (they differ in bf16 only:
    JAX casts the probabilities to the cache dtype)."""
    (qj, qt), (kj, kt), (vj, vt), lv = _case((3, 64, 4, 2, 32, lens, 16), "float32", seed=13)
    j_len = jnp.asarray(lv) if np.ndim(lens) else jnp.int32(lens)
    t_len = torch.from_numpy(lv) if np.ndim(lens) else lens
    out = decode_attention(qt, kt, vt, t_len, block_k=16)
    np.testing.assert_allclose(_np(out), _np(jlayers.decode_attention(qj, kj, vj, j_len)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("off", [0, 8, 13])
def test_history_attention_matches_jax(off, dtype):
    B, C, Smax, H, KV, hd = 2, 8, 32, 4, 2, 32
    rng = np.random.default_rng(off + 3)
    qj, qt = _pair(rng.standard_normal((B, C, H, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    out = history_attention(qt, kt, vt, off)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    np.testing.assert_allclose(_np(out), _np(jlayers.history_attention(qj, kj, vj, off)),
                               atol=TOL[dtype], rtol=0)


def test_flash_decode_on_cpu_takes_the_plain_version_and_does_not_count():
    (_, qt), (_, kt), (_, vt), _ = _case(CASES[1], "float32", seed=2)
    before = flash_decode.launches
    flash_decode(qt, kt, vt, torch.tensor([0, 3, 50], dtype=torch.int32), block_k=16)
    assert flash_decode.launches == before


def test_flash_decode_raises_on_other_devices():
    q = torch.empty(1, 1, 4, 32, device="meta")
    k = torch.empty(1, 16, 2, 32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        flash_decode(q, k, torch.randn(1, 16, 2, 32), 3)
