"""Kernel #2, causal GQA flash attention's forward (``csrc/flash_attention.cu``):
the CUDA functions ``flash_fwd_*``.  One launch over q (B, Sq, H, hd) and
k, v (B, Sk, KV, hd), the queries the last Sq of Sk positions: QK^T and PV
over the kept (query, key) pairs, q and o, k and v each moved once."""
from __future__ import annotations

KERNEL = "flash_fwd_"


def causal_pairs(B: int, H: int, Sq: int, Sk: int) -> int:
    off = Sk - Sq
    return B * H * (Sq * off + Sq * (Sq + 1) // 2)


def work(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int, es: int = 2):
    """(operations, HBM bytes) of one launch; ``es`` the element size."""
    ops = 4.0 * hd * causal_pairs(B, H, Sq, Sk)
    nbytes = 2 * B * Sq * H * hd * es + 2 * B * Sk * KV * hd * es
    return ops, nbytes
