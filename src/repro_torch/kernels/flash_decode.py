"""Flash decode over a dense KV cache: the wrapper around
``csrc/flash_decode.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_decode.py:flash_decode``: one
query row per sequence attends to a dense ``(B, Smax, KV, hd)`` cache;
positions at or past the sequence's length (``cur_len``, a scalar or a
``(B,)`` vector) get no weight, and a lane of length 0 outputs exactly 0.
The kernel walks the cache in blocks of ``block_k`` rows with the same fold
as kernel #1 (``csrc/decode_fold.cuh``), so over a dense view gathered from
pages with ``block_k == page_size`` it equals the paged kernel bitwise.  See
``csrc/flash_decode.cu`` for the bound and the design.  It serves decoding
only and has no backward: on CUDA it raises when autograd would record it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn,
    refuse_detach, runs_plain, stream_ptr,
)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
# cache rows per block when the caller names none; the dense serve round
# passes its page size instead.  Shared memory per block is 2 * block_k * hd
# f32 rows plus the group's scores: 64 rows at hd 128 take 64 KiB.
BLOCK_K = 64


def cur_len_vector(cur_len, B: int, device) -> torch.Tensor:
    """``cur_len`` (an int, a 0-d or a (B,) tensor) as a contiguous (B,)
    int32 tensor on ``device``."""
    lens = torch.as_tensor(cur_len, dtype=torch.int32, device=device).reshape(-1)
    return lens.expand(B).contiguous()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cur_len) -> torch.Tensor:
    """The f32 masked softmax of ``repro/kernels/ref.py:flash_decode_ref``
    with per-sequence lengths; lanes of length 0 are set to exactly 0, as the
    kernel's clamped denominator gives."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    lens = cur_len_vector(cur_len, B, q.device).long()
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(hd))
    valid = torch.arange(Smax, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1), v_cache.float())
    o = torch.where((lens > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len,
                 *, block_k: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k_cache, v_cache: (B, Smax, KV, hd); cur_len: valid
    cache positions, an int or a 0-d or (B,) int tensor.  Plain version on
    the CPU, the kernel on CUDA, walking ``block_k`` rows at a time
    (default :data:`BLOCK_K`; at most ``Smax``)."""
    B, one, H, hd = q.shape
    lens = cur_len_vector(cur_len, B, q.device)
    if runs_plain(q, k_cache, v_cache, lens):
        return flash_decode_plain(q, k_cache, v_cache, lens)
    refuse_detach("flash_decode", q, k_cache, v_cache)
    _, Smax, KV, hd_k = k_cache.shape
    if one != 1 or hd_k != hd or k_cache.shape[0] != B or v_cache.shape != k_cache.shape:
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS or (H // KV) * hd > 128 * 8:
        raise ValueError(f"head_dim {hd} with group {H // KV} not supported")
    bk = BLOCK_K if block_k is None else block_k
    if bk < 1:
        raise ValueError(f"block_k must be >= 1, got {bk}")
    bk = min(bk, Smax)
    check_operand(q, "q")
    check_operand(k_cache, "k_cache", q.dtype)
    check_operand(v_cache, "v_cache", q.dtype)
    code = dtype_code(q)
    o = torch.empty_like(q)
    if Smax == 0:
        return o.zero_()
    if not aligned16(q, k_cache, v_cache, o):
        raise ValueError("operands must be 16-byte aligned")
    fn = kernel_fn("flash_decode", "flash_decode_launch",
                   [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR])
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
             o.data_ptr(), B, H, KV, hd, Smax, bk, 1.0 / math.sqrt(hd), code, stream_ptr(q))
    check_launch("flash_decode", err)
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
