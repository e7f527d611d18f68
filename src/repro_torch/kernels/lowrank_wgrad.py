"""Low-rank Wgrad (MeCeFO technique III): the wrapper around
``csrc/lowrank_wgrad.cu`` and its plain version.

Replaces the TPU kernel
``repro/kernels/lowrank_wgrad.py:lowrank_wgrad_project``:
``A = (x @ V1)^T @ dy`` of shape (r, m), both products accumulated in f32
and A returned in f32.  :func:`lowrank_wgrad` forms the weight gradient
``dW = (V1.float() @ A).to(V1.dtype)`` with ``torch.matmul``, the small
product that lies outside the Pallas kernel in the JAX package too
(``repro/kernels/ops.py:lowrank_wgrad``).  The kernel masks ragged T, n, m
and r itself, so nothing is padded.  See ``csrc/lowrank_wgrad.cu`` for the
bound and the design.

The kernel runs inside the backward of ``core/lowrank.py:lowrank_linear``,
where autograd does not record; on CUDA it raises when autograd would.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (
    INT, PTR, book, check_launch, check_operand, dtype_code, kernel_fn, nbytes, on_meta,
    p_terms, refuse_detach, runs_plain, stream_ptr,
)

MAX_RANK = 256


def lowrank_wgrad_project_plain(x: torch.Tensor, dy: torch.Tensor, v1: torch.Tensor,
                                p_precision: str = "f32") -> torch.Tensor:
    """x: (T, n), dy: (T, m), v1: (n, r) -> A (r, m) f32.  ``p_precision``
    ("f32", the reference; "split", the bf16 kernel's scheme; "bf16") says
    how P = x @ V1 enters the second product (:func:`p_terms`)."""
    p = x.float() @ v1.float()
    dyf = dy.float()
    terms = p_terms(p, p_precision)
    a = terms[0].T @ dyf
    for t in terms[1:]:
        a = a + t.T @ dyf
    return a


def lowrank_wgrad_project_launch(x: torch.Tensor, dy: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad)."""
    refuse_detach("lowrank_wgrad_project", x, dy, v1)
    if x.dim() != 2 or dy.dim() != 2 or v1.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, v1 {tuple(v1.shape)}: want 2-D")
    T, n = x.shape
    m, r = dy.shape[1], v1.shape[1]
    if dy.shape[0] != T or v1.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, v1 {tuple(v1.shape)}")
    if r > MAX_RANK:
        raise ValueError(f"rank {r} above {MAX_RANK}")
    check_operand(x, "x")
    check_operand(dy, "dy", x.dtype)
    check_operand(v1, "v1", x.dtype)
    code = dtype_code(x)
    a = torch.empty(r, m, dtype=torch.float32, device=x.device)
    if T == 0 or n == 0 or m == 0 or r == 0:
        # a zero-width leaf (mamba2's d_ff = 0 FFN has m = 0 and r = 0):
        # A is zeros, and a grid of zero blocks is an invalid launch
        return a.zero_()
    if not on_meta(x):
        n_scratch = kernel_fn("lowrank_wgrad", "lowrank_wgrad_scratch", [INT] * 5,
                              ctypes.c_longlong)(T, n, m, r, code)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
        fn = kernel_fn("lowrank_wgrad", "lowrank_wgrad_launch",
                       [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR])
        err = fn(x.data_ptr(), dy.data_ptr(), v1.data_ptr(), scratch.data_ptr(), a.data_ptr(),
                 T, n, m, r, code, stream_ptr(x))
        check_launch("lowrank_wgrad", err)
        lowrank_wgrad_project.launches += 1
    book("lowrank_wgrad",
         lambda: (2.0 * T * r * (n + m), nbytes(x, dy, v1) + r * m * 4))
    return a


def lowrank_wgrad_project(x: torch.Tensor, dy: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """A = (x @ v1)^T @ dy in f32.  Plain version on the CPU, the kernel on
    CUDA."""
    if runs_plain(x, dy, v1):
        return lowrank_wgrad_project_plain(x, dy, v1)
    return lowrank_wgrad_project_launch(x, dy, v1)


lowrank_wgrad_project.launches = 0


def lowrank_wgrad(x: torch.Tensor, dy: torch.Tensor, v1: torch.Tensor,
                  reduce=None) -> torch.Tensor:
    """Technique III's weight gradient ``dW = V1 @ ((x V1)^T dy)`` (n, m),
    in ``v1``'s dtype.  ``reduce`` (MeCeFO's ``lowrank_sync``) runs on the
    (r, m) factor between the kernel and the product: the data group's
    all-reduce, so dW comes out global."""
    a = lowrank_wgrad_project(x, dy, v1)
    if reduce is not None:
        a = reduce(a)
    return (v1.float() @ a).to(v1.dtype)
