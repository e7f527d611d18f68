"""Kernel #6, MeCeFO's low-rank weight gradient A = (x V1)^T dy
(``csrc/lowrank_wgrad.cu``): the CUDA functions ``lowrank_*`` (the P pass,
the A pass and the reduction of the split parts).  One launch over x (T, n),
dy (T, m), V1 (n, r): both products, x, dy and V1 read once and the f32 A
(r, m) written once."""
from __future__ import annotations

KERNEL = "lowrank_"


def work(T: int, n: int, m: int, r: int, es: int = 2):
    """(operations, HBM bytes) of one launch; ``es`` the element size."""
    ops = 2.0 * T * r * (n + m)
    nbytes = (T * n + T * m + n * r) * es + r * m * 4
    return ops, nbytes
