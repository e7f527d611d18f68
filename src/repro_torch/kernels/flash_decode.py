"""Flash decode over a dense KV cache: the wrapper around
``csrc/flash_decode.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_decode.py:flash_decode``: one
query row per sequence attends to a dense ``(B, Smax, KV, hd)`` cache;
positions at or past the sequence's length (``cur_len``, a scalar or a
``(B,)`` vector) get no weight, and a lane of length 0 outputs exactly 0.
The kernel cuts each lane's ``block_k``-row blocks into splits of
:data:`SPLIT_BLOCKS` blocks, folds the splits in parallel and merges them in
order, with the same code as kernel #1 (``csrc/decode_fold.cuh``), so over a
dense view gathered from pages with ``block_k == page_size`` it equals the
paged kernel bitwise.  See ``csrc/flash_decode.cu`` for the bound and the
design.  It serves decoding only and has no backward: on CUDA it raises when
autograd would record it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn,
    refuse_detach, runs_plain, stream_ptr,
)

NEG_INF = -1e30
# head widths the decode sources are built for; any group size G = H / KV
# (a group wider than 1024 elements is cut into sub-groups in the kernel)
HEAD_DIMS = (32, 64, 96, 128, 192)
# cache rows per block when the caller names none; the dense serve round
# passes its page size instead
BLOCK_K = 64
# fold blocks (pages for kernel #1, block_k rows for kernel #5) per split of
# a lane's cache: one constant, never sized from B, Smax or the lengths, so a
# lane's splits, and its output, depend on its own length alone.  Chosen by
# the split sweep on the card (PERF.md).
SPLIT_BLOCKS = 4


def cur_len_vector(cur_len, B: int, device) -> torch.Tensor:
    """``cur_len`` (an int, a 0-d or a (B,) tensor) as a contiguous (B,)
    int32 tensor on ``device``."""
    lens = torch.as_tensor(cur_len, dtype=torch.int32, device=device).reshape(-1)
    return lens.expand(B).contiguous()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cur_len, split: int | None = None) -> torch.Tensor:
    """The f32 masked softmax of ``repro/kernels/ref.py:flash_decode_ref``
    with per-sequence lengths; lanes of length 0 are set to exactly 0, as the
    kernel's clamped denominator gives.

    ``split`` (rows per split; tests only) computes it as the kernels do:
    each lane on its own, per split of ``split`` rows a partial (m, l, acc)
    over its unmasked rows, then the splits merged in ascending order
    (:func:`split_partials`, :func:`merge_splits`)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    lens = cur_len_vector(cur_len, B, q.device).long()
    qg = q.reshape(B, KV, H // KV, hd).float()
    valid = torch.arange(Smax, device=q.device)[None, :] < lens[:, None]
    if split is not None:
        o = torch.stack([merge_splits(*split_partials(qg[b], k_cache[b].float(),
                                                      v_cache[b].float(), valid[b], split))
                         for b in range(B)])
        return o.reshape(B, 1, H, hd).to(q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1), v_cache.float())
    o = torch.where((lens > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def split_partials(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                   split: int):
    """One lane's f32 partials of the kernels' first pass, per split of
    ``split`` cache rows: m = the largest scaled score of the split (NEG_INF
    when every row is masked), l = sum of p = exp(s - m) over unmasked rows
    (masked rows add exactly 0), acc = sum of p v.  (The kernels keep s and m
    in base-2 units, p = 2^(s - m): the same p, l and acc.)  qg: (KV, G, hd); k, v:
    (Smax, KV, hd) f32; valid: (Smax,).  Returns m, l (KV, G, n) and acc
    (KV, G, n, hd), n = ceil(Smax / split)."""
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    Smax, KV, hd = k.shape
    n = -(-Smax // split)
    pad = n * split - Smax
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).reshape(n, split, KV, hd)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(n, split, KV, hd)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(1, 1, n, split)
    s = torch.einsum("kgh,nskh->kgns", qg, k) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(dim=-1), torch.einsum("kgns,nskh->kgnh", p, v)


def merge_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The kernels' combine pass: M = max m_i, then l = sum e^(m_i - M) l_i
    and acc = sum e^(m_i - M) acc_i taken in ascending split order, and
    acc / max(l, 1e-30) (exactly 0 where no row was unmasked).  m, l: (...,
    n); acc: (..., n, hd)."""
    mx = m.amax(dim=-1)
    c = torch.exp(m - mx[..., None])
    lsum = torch.zeros_like(mx)
    a = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        lsum = lsum + c[..., i] * l[..., i]
        a = a + c[..., i, None] * acc[..., i, :]
    return a / lsum.clamp(min=1e-30)[..., None]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len,
                 *, block_k: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache, v_cache: (B, Smax, KV, hd); cur_len: valid
    cache positions, an int or a 0-d or (B,) int tensor.  Plain version on
    the CPU, the kernel on CUDA, folding ``block_k`` rows a block (default
    :data:`BLOCK_K`; at most ``Smax``) and :data:`SPLIT_BLOCKS` blocks a
    split."""
    B = q.shape[0]
    lens = cur_len_vector(cur_len, B, q.device)
    if runs_plain(q, k_cache, v_cache, lens):
        return flash_decode_plain(q, k_cache, v_cache, lens)
    return flash_decode_launch(q, k_cache, v_cache, lens,
                               block_k=BLOCK_K if block_k is None else block_k)


def split_scratch(q: torch.Tensor, n_blocks: int, split_blocks: int) -> torch.Tensor:
    """The f32 scratch of the split partials for q (B, 1, H, hd) over
    ``n_blocks`` fold blocks a lane: B * H * ceil(n_blocks / split_blocks) *
    (hd + 2) elements, sized from shapes only."""
    if split_blocks < 1:
        raise ValueError(f"split_blocks must be >= 1, got {split_blocks}")
    B, _, H, hd = q.shape
    n_split = -(-n_blocks // split_blocks)
    return torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32, device=q.device)


def check_decode_heads(q: torch.Tensor, KV: int) -> None:
    H, hd = q.shape[2], q.shape[3]
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def flash_decode_launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        lens: torch.Tensor, *, block_k: int,
                        split_blocks: int = SPLIT_BLOCKS) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad): both
    passes of the kernel over (B,) int32 ``lens``, which it reads on the
    device only.  ``split_blocks`` other than :data:`SPLIT_BLOCKS` is for
    the split sweep."""
    refuse_detach("flash_decode", q, k_cache, v_cache)
    B, one, H, hd = q.shape
    _, Smax, KV, hd_k = k_cache.shape
    if one != 1 or hd_k != hd or k_cache.shape[0] != B or v_cache.shape != k_cache.shape:
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)}")
    check_decode_heads(q, KV)
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    bk = min(block_k, Smax)
    check_operand(q, "q")
    check_operand(k_cache, "k_cache", q.dtype)
    check_operand(v_cache, "v_cache", q.dtype)
    check_operand(lens, "lens", torch.int32)
    code = dtype_code(q)
    o = torch.empty_like(q)
    if Smax == 0:
        return o.zero_()
    if not aligned16(q, k_cache, v_cache, o):
        raise ValueError("operands must be 16-byte aligned")
    part = split_scratch(q, -(-Smax // bk), split_blocks)
    fn = kernel_fn("flash_decode", "flash_decode_launch",
                   [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT,
                    PTR])
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
             part.data_ptr(), o.data_ptr(), B, H, KV, hd, Smax, bk, split_blocks,
             1.0 / math.sqrt(hd), code, stream_ptr(q))
    check_launch("flash_decode", err)
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
