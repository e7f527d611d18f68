"""The split-KV arithmetic of kernels #1 and #5, on the CPU, against the
JAX package, live.

The CUDA kernels cut each lane's cache into splits of ``SPLIT_BLOCKS`` fold
blocks, fold each split into an f32 partial (m, l, acc) and merge the
splits in ascending order.  ``flash_decode_plain(..., split=rows)`` and
``paged_decode_plain(..., split=rows)`` do the same in plain PyTorch.  The
same numpy inputs go through them and through the JAX Pallas kernels in
interpret mode (``ops.flash_decode`` and ``paged_flash_decode``), at the
tolerances of ``tests/test_kernels.py``: 2e-5 in f32 and 3e-2 in bf16.
In f32 the split result is also held to the unsplit plain version within
1e-6 of its largest magnitude (the same sums, regrouped), and a lane's
split result must not change when the batch around it changes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels.paged_decode import paged_flash_decode as jax_paged  # noqa: E402

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    SPLIT_BLOCKS, flash_decode_plain, merge_splits, split_scratch,
)
from repro_torch.kernels.paged_decode import paged_decode_plain  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPLIT_REL = 1e-6

CASES = [
    # (B, Smax, H, KV, hd, lens, block rows): a split is SPLIT_BLOCKS blocks
    (3, 64, 4, 4, 32, [0, 1, 64], 4),              # G 1: a null lane, one row, 4 splits
    (4, 72, 8, 4, 64, [15, 16, 17, 33], 4),        # G 2: a split's rows -1, exact, +1
    (2, 100, 8, 2, 128, [31, 100], 8),             # G 4, hd 128: ragged Smax, split - 1
    (2, 256, 4, 2, 32, [255, 129], 4),             # many splits
    (2, 48, 4, 1, 64, [5, 20], 4),                 # G 4: splits of masked rows only
    # the head shapes of the repo's configs: phi-3-vision's hd 96 (MHA),
    # nemotron-4-340b's hd 192 (G 12), glm4-9b's G 16 and granite-34b's G 48
    (2, 40, 4, 4, 96, [0, 40], 4),
    (2, 36, 12, 1, 192, [17, 36], 4),
    (2, 32, 16, 1, 128, [9, 32], 4),
    (1, 24, 48, 1, 128, [19], 4),
]
IDS = ["G1-hd32", "G2-hd64-edges", "G4-hd128-ragged", "many-splits", "masked-splits",
       "G1-hd96", "G12-hd192", "G16-hd128", "G48-hd128"]


def _pair(a32: np.ndarray, dtype: str):
    j = jnp.asarray(a32, jnp.dtype(dtype))
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).astype(np.float32)
    return np.asarray(x).astype(np.float32)


def _case(case, dtype, seed=0):
    B, Smax, H, KV, hd, lens, bk = case
    rng = np.random.default_rng(seed + Smax + hd)
    q = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    k = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    v = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    return q, k, v, np.asarray(lens, np.int32), bk * SPLIT_BLOCKS


def _pages(case, dtype, seed=0):
    """The case's cache cut into pages of ``block rows`` in a shuffled pool
    (page 0 the null page), with each lane's table."""
    B, Smax, H, KV, hd, lens, ps = case
    P = -(-Smax // ps)
    n_pages = 1 + B * P
    rng = np.random.default_rng(seed + 100 + Smax)
    q = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    k = _pair(rng.standard_normal((n_pages, ps, KV, hd)), dtype)
    v = _pair(rng.standard_normal((n_pages, ps, KV, hd)), dtype)
    tables = (rng.permutation(n_pages - 1) + 1).reshape(B, P).astype(np.int32)
    return q, k, v, tables, np.asarray(lens, np.int32), ps * SPLIT_BLOCKS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_split_matches_pallas(case, dtype):
    (qj, qt), (kj, kt), (vj, vt), lens, split = _case(case, dtype)
    out = flash_decode_plain(qt, kt, vt, torch.from_numpy(lens), split)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    pallas = ops.flash_decode(qj, kj, vj, jnp.asarray(lens), block_k=case[6], interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=TOL[dtype], rtol=0)
    zero = torch.from_numpy(lens == 0)
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_paged_split_matches_pallas_and_dense_split(case, dtype):
    (qj, qt), (kj, kt), (vj, vt), tables, lens, split = _pages(case, dtype)
    t_tab, t_len = torch.from_numpy(tables), torch.from_numpy(lens)
    out = paged_decode_plain(qt, kt, vt, t_tab, t_len, split)
    pallas = jax_paged(qj, kj, vj, jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=TOL[dtype], rtol=0)
    B, KV, hd = qt.shape[0], kt.shape[2], kt.shape[3]
    kd = kt[t_tab.long()].reshape(B, -1, KV, hd)
    vd = vt[t_tab.long()].reshape(B, -1, KV, hd)
    assert torch.equal(out, flash_decode_plain(qt, kd, vd, t_len, split))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_equals_unsplit_in_f32(case):
    (_, qt), (_, kt), (_, vt), lens, split = _case(case, "float32")
    t_len = torch.from_numpy(lens)
    ref = flash_decode_plain(qt, kt, vt, t_len)
    for rows in (split, 1, 7, case[1]):  # the kernels' split, one row, odd, one split
        out = flash_decode_plain(qt, kt, vt, t_len, rows)
        err = float((out - ref).abs().max())
        assert err <= SPLIT_REL * float(ref.abs().max()), (rows, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_lane_invariant_to_its_batch(case, dtype):
    """Lane b decoded alone, and among other lanes of other lengths, gives
    bitwise the same split result (the kernels' grid never sizes a lane's
    splits from the batch)."""
    (_, qt), (_, kt), (_, vt), lens, split = _case(case, dtype)
    t_len = torch.from_numpy(lens)
    batch = flash_decode_plain(qt, kt, vt, t_len, split)
    for b in range(qt.shape[0]):
        alone = flash_decode_plain(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1], t_len[b:b + 1], split)
        assert torch.equal(alone[0], batch[b]), b
    # the same lanes in the reverse order, and with a longer lane beside them
    rev = flash_decode_plain(qt.flip(0), kt.flip(0), vt.flip(0), t_len.flip(0), split)
    assert torch.equal(rev.flip(0), batch)


def test_merge_splits_is_the_ascending_order_sum():
    """One split merges to acc / l; a split with no unmasked row (m = NEG_INF,
    l = 0) adds nothing; no split at all gives exactly 0."""
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.standard_normal((1, 3, 8)).astype(np.float32))
    m = torch.tensor([[0.5, fd.NEG_INF, -1.0]])
    l = torch.tensor([[2.0, 0.0, 3.0]])
    acc[0, 1] = 0.0
    c = torch.exp(m - 0.5)
    want = (c[0, 0] * acc[0, 0] + c[0, 2] * acc[0, 2]) / (c[0, 0] * 2.0 + c[0, 2] * 3.0)
    torch.testing.assert_close(merge_splits(m, l, acc)[0], want, rtol=1e-6, atol=0)
    one = merge_splits(m[:, :1], l[:, :1], acc[:, :1])
    assert torch.equal(one[0], acc[0, 0] / 2.0)
    none = merge_splits(torch.full((1, 2), fd.NEG_INF), torch.zeros(1, 2), torch.zeros(1, 2, 8))
    assert torch.equal(none, torch.zeros(1, 8))


def test_split_scratch_sized_from_shapes():
    q = torch.empty(8, 1, 16, 128)
    part = split_scratch(q, 64, SPLIT_BLOCKS)
    n_split = -(-64 // SPLIT_BLOCKS)
    assert part.dtype == torch.float32 and part.numel() == 8 * 16 * n_split * (128 + 2)
    assert split_scratch(q, 63, 4).numel() == split_scratch(q, 64, 4).numel()
    with pytest.raises(ValueError, match="split_blocks"):
        split_scratch(q, 64, 0)
